"""Drive the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py

Phases, one line of output or more each (a phase that fails raises, and
the process exits non-zero):

1. device   — CUDA present; torch, CUDA, nvcc versions; card name and
              power limit (nvidia-smi).
2. build    — nvcc builds procgen_tpu_torch/csrc/*.cu, one process per
              source; seconds, ptxas.
3. maze     — the static-prefix kernel ``render_suffix`` against its plain
              torch version, byte for byte, on the prep of 4096 maze states
              after 20 random steps and on a made-up batch; the slice
              ``entry.make_env_fns(4096, "maze", device="cuda")``: 20
              warm-up and 100 timed steps (every slice), one
              ``render_suffix`` launch a step, env-steps/s, a per-layer
              split, the kernel's time
              against the plain version's and its bound; a 64-env
              ``ProcgenGym3Env`` for 50 steps on the card and on the CPU,
              bit-equal; the maze_easy recording replayed exactly on the
              card.
4. miner    — the whole-frame kernel ``render_frame`` against its plain
              torch version, byte for byte, on the prep of 4096 miner-easy
              states after 20 random steps, of 4096 miner-hard states and
              on a made-up batch; the slice ``make_env_fns(4096, "miner",
              device="cuda")`` for 20 warm-up and 100 timed steps, one
              ``render_frame`` launch a step; a 64-env miner ``ProcgenGym3Env`` for 50 steps on the
              card and on the CPU, bit-equal, latents included; the
              miner_easy recording replayed exactly on the card.
5. coinrun  — ``render_frame`` with the decor pool against its plain
              version, byte for byte, on the prep of 4096 coinrun-easy
              states after 20 random steps under the whole-world camera
              and under the agent-centred one, of 4096 coinrun-hard
              states, and on a made-up batch with both pools full; the
              slice ``make_env_fns(4096, "coinrun", device="cuda")``, one
              ``render_frame`` launch a step; 30 timed steps of a
              4096-env ``ProcgenGym3Env`` (agent-centred, the default); a
              64-env one for 50 steps on the card and on the CPU,
              bit-equal; the coinrun_easy recording replayed exactly on
              the card.
6. fruitbot — ``render_frame`` with the tiled background against its plain
              version, byte for byte, on the prep of 4096 fruitbot-easy
              states after 20 random steps under the whole-world camera
              and the agent-centred one, of 4096 fruitbot-hard states and
              on a made-up tiled batch; the slice ``make_env_fns(4096,
              "fruitbot", device="cuda")``, one ``render_frame`` launch a
              step; the kernel's time on easy under both cameras and on
              hard; 30 timed steps of a 4096-env centred
              ``ProcgenGym3Env``; a 64-env one for 50 steps on the card
              and on the CPU, bit-equal; the fruitbot_easy recording
              replayed exactly on the card.
7. starpilot — ``core/libm.py``'s ``sincosf`` and ``atan2f`` on the card
              against the same functions on the CPU, bit for bit, on
              4,194,304 reset angles, 1,048,576 angles in (-120, 120) and
              1,048,576 of |x| from 120 to 2^127 (glibc's reduce_large; the
              sine and cosine of each) and 4,194,304 pairs; the C++
              double expressions of a draw, card against CPU at every
              distinct ``rand01`` value: bigfish's fish radius (f64
              ``pow``) and starpilot's spawner velocities (f64 ``sin``
              and ``cos`` times each speed), the CPU half computed by
              the CPU worker beforehand; ``render_frame`` with the time-scrolled
              background against its plain version, byte for byte, on the
              prep of 4096 starpilot-easy states after 20 random steps
              under both cameras, of 4096 hard and 4096 extreme states and
              on a made-up scrolled batch; the slice ``make_env_fns(4096,
              "starpilot", device="cuda")``, one ``render_frame`` launch a
              step; the kernel's time under both cameras; 30 timed steps
              of a 4096-env centred ``ProcgenGym3Env``; a 64-env one for 50
              steps on the card and on the CPU, bit-equal, every state leaf
              included; the starpilot_easy recording replayed exactly on
              the card.
8. plunder  — the static-prefix kernel's decor instance (``render_suffix``
              with the explosion pool) against its plain version, byte for
              byte, on the prep of 4096 plunder-easy states after 20 steps
              of the slice's program, of 4096 plunder-hard states after 30,
              both with live explosions, and on a made-up batch with a full
              decor pool; the slice ``make_env_fns(4096, "plunder",
              device="cuda")``, one ``render_suffix`` launch a step; the
              kernel's time on the slice's states against the plain
              version's and its bound; a 64-env ``ProcgenGym3Env`` for 50
              steps on the card and on the CPU, bit-equal, every state leaf
              included; the plunder_easy recording replayed exactly on the
              card.
9. leaper   — the static-prefix kernel's entity-only instance
              (``render_suffix<false>``, cap 80: the finish line tiled
              across the frame, the frog's tall rectangle in quarter turns)
              against its plain version, byte for byte, on the prep of 4096
              leaper-easy states after 20 steps of the slice's program, of
              4096 hard and 4096 extreme states after 20, and on 4096 envs
              of edge-case slots at cap 80; the slice ``make_env_fns(4096,
              "leaper", device="cuda")`` for 20 warm-up and 100 timed steps
              (its 64-env resets each pre-roll the lanes for 200-360
              iterations on the host), one ``render_suffix`` launch a step,
              the split with the 64-env reset's torch operations and
              milliseconds; the kernel's time against the plain version's
              and its bound; a 64-env ``ProcgenGym3Env`` for 50 steps on the
              card and on the CPU, bit-equal, every state leaf included;
              the leaper_easy recording replayed exactly on the card.
10. bigfish — the same for bigfish (cap 40, the fish reflected and
              growing; hard states after 20 steps): its slice runs the
              sequential reverse collision scan; the bigfish_easy recording
              replayed on the card.
11. dodgeball — the static-prefix kernel's decor instance at dodgeball's
              caps (72 entity slots, 16 dust clouds; lava walls tiled
              along x and along y, the rotation banks of the balls, the
              agent and the enemies) against its plain version, byte for
              byte, on the prep of 4096 easy states after 20 steps of the
              slice's program, of 4096 hard and 4096 extreme states after
              30, and on 4096 envs of edge-case slots at those caps with
              made-up tiled walls and bank rows; the slice
              ``make_env_fns(4096, "dodgeball", device="cuda")``, 20
              warm-up and 100 timed steps (a 64-env reset nearly every
              step), one ``render_suffix`` launch a step; the kernel's time, its bound and its instance's
              occupancy; a 64-env ``ProcgenGym3Env`` for 50 steps on the
              card and on the CPU, bit-equal, every state leaf included;
              the dodgeball_easy recording replayed exactly on the card.
12. bossfight — the static-prefix kernel's decor instance at the largest
              pools a game has (72 entity slots, 160 laser trails and
              explosions: 69,104 B of dynamic shared memory a block; the
              enemy bullets and their trails on the rotation banks): the
              slice ``make_env_fns(4096, "bossfight", device="cuda")``, one ``render_suffix`` launch a
              step; then the kernel against its plain version, byte for
              byte, on the prep of the slice's 4096 easy states, of 4096
              hard states after 30 steps, and on 4096 envs of edge-case
              slots at those caps with made-up tiled slots and bank rows;
              the instance's registers, spills, shared memory and blocks
              an SM; the kernel's time and bound on the slice's states; a
              64-env ``ProcgenGym3Env`` for 50
              steps on the card and on the CPU, bit-equal, every state leaf
              included; the bossfight_easy recording replayed exactly on
              the card.
13. climber — the slice ``make_env_fns(4096, "climber",
              device="cuda")``, one
              ``render_frame`` launch a step; then ``render_frame`` under
              the game's own camera against its plain version, byte for
              byte, on the prep of the slice's 4096 easy states and of 4096
              hard states after 20 steps, each under the whole-world camera
              (a 64-cell window) and the centred one (the world's width in
              view, a 19-cell window), and on 4096 envs of edge-case slots
              in the centred window; the kernel's time and bound under both
              cameras on the slice's states; 30 timed steps of a 4096-env centred
              ``ProcgenGym3Env``; a 64-env one for 50 steps on the card and
              on the CPU, bit-equal, every state leaf included; the
              climber_easy recording replayed exactly on the card.
14. ninja   — the slice ``make_env_fns(4096, "ninja", device="cuda")``,
              one ``render_frame`` launch a step (the throwing stars' grid dispatch on the path);
              then ``render_frame`` against its plain version, byte for
              byte, on the prep of the slice's 4096 easy states and of
              4096 hard states after 20 steps of jumps and throws, each
              under the whole-world camera (64 cells) and the centred one
              (13 and 19 cells), and on 4096 envs of edge-case slots in
              the centred window; the kernel's time and bound under both
              cameras and the instances' occupancy; 30 timed steps of a
              4096-env centred ``ProcgenGym3Env``; a 64-env one for 50
              steps on the card and on the CPU, bit-equal, every state
              leaf included; the ninja_easy recording replayed exactly on
              the card.
15. chaser  — the slice ``make_env_fns(4096, "chaser", device="cuda")``,
              one ``render_frame`` launch a step; then ``render_frame`` against its plain version,
              byte for byte, on the prep of the slice's 4096 easy states
              and of 4096 hard and extreme states after 20 steps (windows
              of 11, 13 and 19 cells, the orbs drawn at an inset of 0.3),
              on 4096 envs in each window whose pixels fall within a few
              ulps of the orbs' edges, and on 4096 envs of edge-case
              slots; the kernel's time and bound in each window; a 64-env
              ``ProcgenGym3Env`` for 50 steps on the card and on the CPU,
              bit-equal, every state leaf included; the chaser_easy
              recording replayed exactly on the card.  The game forces
              the static camera: no centred gym3 run.
16. heist   — the slice ``make_env_fns(4096, "heist", device="cuda")``,
              one ``render_frame`` launch a step; then ``render_frame``
              against its plain version, byte for byte, on the prep of
              the slice's 4096 easy states and of 4096 hard and 4096
              memory states after 20 steps (windows of 9, 13 and, centred,
              11 cells), each as they are and with every key held (the
              key ring in screen coordinates at render_z 1) and the agent
              in its 8 facings (rotation banks), and on 4096 envs of
              edge-case slots in the centred window; the kernel's time
              and bound in each window; 30 timed steps of a 4096-env
              memory-mode ``ProcgenGym3Env`` (the game centres only
              there); a 64-env one for 50 steps on the card and on the
              CPU, bit-equal, every state leaf included; the heist_easy
              recording replayed exactly on the card.
17. jumper  — the slice ``make_env_fns(4096, "jumper", device="cuda")``,
              one ``render_frame`` launch a step (the compass and bar
              drawn after it); then ``render_frame`` against its plain
              version, byte for byte, on the prep of the slice's 4096
              easy states and of 4096 hard and 4096 memory states after 20
              steps, each under the whole-world camera (20, 40, 45 cells)
              and the centred one (15, 19, 19), and on 4096 envs of
              edge-case slots with both pools full (64 + 16) in easy's two
              windows; the kernel's time and bound in each window; 30
              timed steps of a 4096-env centred ``ProcgenGym3Env``; a
              64-env one for 50 steps on the card and on the CPU,
              bit-equal, every state leaf included; the jumper_easy
              recording replayed exactly on the card.
18. memory  — memory mode's centred whole frame: ``render_frame`` on the
              window of ``visibility + 3`` cells (11 for maze and miner, 19
              for dodgeball with both pools) against its plain version,
              byte for byte, on the prep of 4096 memory states of each
              game and on edge-case slots at dodgeball's caps; the
              kernel's time and bound on maze's and dodgeball's states and
              the instances' occupancy; 64-env maze memory on the card and
              on the CPU for 50 steps, bit-equal, every state leaf
              included; the maze_memory recording replayed exactly on the
              card, its ``render_frame`` launches counted (memory mode has
              no timed slice).
19. genassets — generated assets: the background painter
              ``assetgen_bg`` against its plain version, byte for byte, on
              the draw blocks of 256 seeded streams and on a made-up block
              that takes the longest path, its time at 64 envs (a
              replenish chunk) and 4096 (the initial reset) and one env's
              serial latency, and at 4096 envs the 32 envs within 4 of
              its chunk edges against the plain version; ``render_frame``
              on each env's painted canvas against its plain version, byte
              for byte, on 4096 states after 20 steps of coinrun easy
              (whole-world and centred cameras), fruitbot easy (tiled),
              miner easy and starpilot easy (cropped), and its time on
              painted coinrun and fruitbot against the atlas background's
              on the same states; the 4096-env coinrun
              ``ProcgenGym3Env(use_generated_assets=True)`` for 60 timed
              act + observe steps after 10, in alternating windows with the
              same env without generated assets, one ``render_frame``
              launch a step, the painter's launches counted (a replenish
              among them), a per-layer split of both steps, and the
              centred fruitbot one for 40 after 10, a replenish among its
              painter launches; 64-env generated-assets maze and coinrun
              on the card and on the CPU for 50 steps, bit-equal, every
              state leaf included; the maze_genassets recording replayed
              exactly on the card.
20. surfaces — the gym3 surfaces beside the step: both joint recordings
              (maze,miner and bossfight,chaser,dodgeball) replayed
              exactly on the card; a 4096-env ``maze,miner``
              ``ProcgenGym3Env`` for 30 timed act + observe steps after
              10, one ``render_suffix`` and one ``render_frame`` launch a
              step, its interleaved frames of the last step equal to both
              kernels' plain versions byte for byte, and each kernel's
              time and bound on its 2048 sub-game states; ``get_state``
              of a 4096-env maze env and ``set_state`` into a differently
              seeded one, timed, which then replays 20 steps bit-equal;
              64-env maze blobs after 20 steps and a 16-env coinrun
              ``render_mode="rgb_array"`` env's 512x512 ``info["rgb"]``
              (reset and 2 steps) on the card equal to the CPU worker's,
              the 512 frame's milliseconds an env; ``rollout_full`` of 10
              steps equal to 10 act + observe steps.
21. profile — 3 more steps of each slice under ``torch.profiler``:
              device time a step and the device busy share.  Last of the
              measured phases, since the host dispatch stays slower once
              the profiler has run.
22. result  — each phase's wall seconds, a JSON line of the kernels
              (``render_suffix``, ``render_frame`` and ``assetgen_bg``
              once for each path that launches them), the card line, and
              the last line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --only ninja,chaser`` runs the named phases of
``PHASES`` alone, with the build and the profile of their slices.

Each path's launch counts are set to 0 just before its slice and read just
after it; launches made to compare or time a kernel do not count.  The
CPU halves of the 64-env card-against-CPU runs run meanwhile in a worker
process of their own (``cpu_worker``, started after the device check,
stopped at the end); each card half is compared with its CPU half step by
step.  It needs one card and imports nothing of JAX.
"""

import collections
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

NUM_ENVS = 4096
# every slice runs 20 warm-up and 100 timed steps, and each centred gym3
# env 30 timed steps after 10: with eight slices at the bench protocol's
# 100 + 300 and the gym3 envs at 100, the whole script took 1,100.6 s on
# a host where maze takes 39.6 ms a step and 1,280 s, past its 1,200 s
# limit, on one where it takes 52.6 ms.  Over fewer timed steps a
# slice's rate hangs on its few 64-env resets (heist's read from 27,798
# to 58,172 env-steps/s over 50 steps on three H100 hosts)
WARM_STEPS = 20
TIMED_STEPS = 100
GYM_TIMED_STEPS = 30
# random steps before their kernel checks (the slices of maze to
# dodgeball, and generated assets)
PRE_STEPS = 20
# the generated-assets gym3 env is timed over 60 steps, in alternating
# windows with the env without generated assets
GENASSETS_TIMED_STEPS = 60
# the split and the profile run fewer steps than the slices, to keep the
# script inside its limit on a slow host
PROFILE_STEPS = 3
SPLIT_STEPS = 10
# timed calls of a plain version, after one untimed, in its one turn
# between the kernel's two: up to 0.9 s a call (bossfight's 232 slots);
# two turns' readings agreed to 0.2%, so a second turn is not taken
PLAIN_ITERS = 1
T_START = time.perf_counter()

# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s and f32 FLOP/s outside
# the tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12


def log(phase, msg):
    print(f"[{phase} +{time.perf_counter() - T_START:.0f}s] {msg}", flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean milliseconds of ``fn()`` over ``iters`` calls, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved, flops):
    """(bound_ms, bound_by): the larger of the bytes moved (each input read
    once, each output written once) over the HBM rate, and the f32
    operations over the f32 peak."""
    t_bytes = moved / HBM_BYTES_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def slot_ops(ent_f, ent_i, atlas, nz, zs, rk, torch, count=None):
    """f32 operations the sprite pass and its composites need on this
    data: 8 for each live slot (its rectangle's ends and the reciprocals of
    its extents); 24 a pixel inside a live slot's rectangle (two
    divisions, the tiling and texel index arithmetic, the alpha product,
    the RGBA blend); 9 a pixel for each composited canvas ``zs`` whose
    alpha there is above 0 (elsewhere the composite is the identity).  The
    kernel's own test of every slot's rectangle at every pixel is its
    design's cost, not the function's, and is not counted.  ``count``
    ([N]): the pool's live count, past which no slot paints."""
    pix = torch.arange(64, dtype=torch.float32, device=ent_f.device) + 0.5
    live = (ent_i[..., rk.EI_LIVE] > 0) & (ent_i[..., rk.EI_Z] >= 0)
    if count is not None:
        slots = torch.arange(ent_i.shape[1], device=ent_i.device)[None, :]
        live = live & (slots < count[:, None])

    def span(origin, extent):  # pixels of one axis inside the rectangle
        u = (pix - ent_f[..., origin, None]) / ent_f[..., extent, None]
        return ((u >= 0) & (u < 1)).sum(-1)

    inside = span(rk.EF_X0, rk.EF_W2) * span(rk.EF_Y0, rk.EF_H2)
    canv = rk._slot_canvases(ent_f, ent_i, atlas, nz, count=count)
    lit = sum(int((canv[z, ..., 3] > 0).sum()) for z in zs if z >= 0)
    return 8 * int(live.sum()) + 24 * int(inside[live].sum()) + 9 * lit


def frame_ops(x, rk, torch):
    """f32 operations ``render_frame`` needs on this data: the slots of
    both pools as in ``slot_ops``; per env 16 for each pixel row and column
    (the world coordinates, background and cell-window indices); 10 a pixel
    where the tile texel's alpha is above 0 (the blend) and 6 a pixel of a
    valid cell no tile covers (the inset test)."""
    n = x.sf.shape[0]
    _, _, inside, crow, ccol, row, tex = rk.grid_lookup(x)
    nidx = torch.arange(n, device=x.sf.device)[:, None, None]
    valid = x.cell5[:, 3][nidx, crow, ccol] > 0.5
    cells = inside & (row >= x.grid_opaque) & valid
    ops = slot_ops(x.ent_f, x.ent_i, x.ent_atlas, x.nz, x.z_slots, rk, torch)
    if x.nzd:
        ops += slot_ops(x.dec_f, x.dec_i, x.ent_atlas, x.nzd, x.dz_slots, rk, torch)
    return (ops + n * 2 * 64 * 16 + 10 * int((tex[..., 3] > 0).sum())
            + 6 * int(cells.sum()))


def frame_bytes(x, rk, torch):
    """Bytes ``render_frame`` must move on this data, each read once: the
    frame written; per env its scalars, the row-table entry of every cell
    its pixels fall in, the valid plane of those cells no tile covers, the
    other four planes of the valid ones among these, and the slots below
    each pool's live count; of the shared atlases, the rows this data
    samples (of the background images, the rows some pixel shows, tiled or
    cropped, or the texels some pixel shows, scrolled; of each env's own
    painted canvas, the texels some pixel shows)."""
    n, NC = x.sf.shape[0], x.gtab.shape[1]
    dev = x.sf.device
    _, _, inside, crow, ccol, row, _ = rk.grid_lookup(x)
    idx = (crow * NC + ccol).expand(n, 64, 64).reshape(n, -1)

    def cells(mask):  # [N, NC*NC]: cells that some pixel where mask holds reads
        hit = torch.zeros((n, NC * NC), dtype=torch.int32, device=dev)
        return hit.scatter_add_(1, idx, mask.reshape(n, -1).to(torch.int32)) > 0

    read = cells(inside)
    uncovered = cells(inside & (row >= x.grid_opaque))
    valid = uncovered & (x.cell5[:, 3].reshape(n, -1) > 0.5)
    words = int(read.sum()) + int(uncovered.sum()) + 4 * int(valid.sum())

    slots, ent_rows = 0, []
    for f, i, c in ((x.ent_f, x.ent_i, rk.SI_ENT_COUNT), (x.dec_f, x.dec_i, rk.SI_DEC_COUNT)):
        below = torch.arange(i.shape[1], device=dev)[None, :] < x.si[:, c:c + 1]
        slots += int(below.sum())
        ent_rows.append(i[..., rk.EI_ROW][below & (i[..., rk.EI_LIVE] > 0)])
    ent_rows = torch.cat(ent_rows).clamp(0, x.ent_atlas.shape[0] - 1)
    ga, ea, bg = x.grid_atlas, x.ent_atlas, x.bg_atlas
    atlas = (ent_rows.unique().numel() * ea[0].numel()
             + row[inside].unique().numel() * ga[0].numel())
    if x.bg_mode == rk.BG_SCROLL or x.per_env_bg:
        # the scrolled tiles show each image row across a shifting window
        # of its columns, and each env reads a window of its own canvas:
        # the texels some pixel shows
        bi, row_idx, col_idx, in_y, in_x = rk.background_lookup(x)
        BH, BW = bg.shape[1], bg.shape[2]
        key = ((bi[:, None, None] * BH + row_idx[:, :, None]) * BW
               + col_idx[:, None, :])
        shown = in_y[:, :, None] & in_x[:, None, :]
        atlas += key[shown].unique().numel() * bg.shape[3]
    elif x.bg_mode != rk.BG_NONE:
        bi, row_idx, _, in_y, in_x = rk.background_lookup(x)
        shown = in_y & in_x.any(dim=1, keepdim=True)
        image_rows = (bi[:, None] * bg.shape[1] + row_idx)[shown].unique().numel()
        atlas += image_rows * bg[0, 0].numel()
    return (n * 64 * 64 * 3 + nbytes(x.sf, x.si) + 4 * words
            + (rk.EF_N + rk.EI_N) * 4 * slots + atlas)


def frame_bound(x, rk, torch):
    """(bound_ms, bound_by, work) of ``render_frame`` on ``x``:
    ``frame_bytes`` against ``frame_ops``."""
    moved = frame_bytes(x, rk, torch)
    ops = frame_ops(x, rk, torch)
    return (*bound(moved, ops), f"{moved} bytes, {ops} f32 ops")


def suffix_bound(base, ent_f, ent_i, atlas, nz, decor, rk, torch, count=None):
    """(bound_ms, bound_by, work) of ``render_suffix``: the bytes it must
    move on this data, each read once (the base frame read and the frame
    written, the slots below each pool's live count and the counts; the
    entity-only instance takes no count, so for it the slots below the
    pool's ``count`` (int32 [N], from the states) and each other slot's
    live flag; the atlas rows the live slots sample), against the f32
    operations of the pools' slots and composites (``slot_ops``)."""
    dev = base.device
    pools = [(ent_i, count if decor is None else decor.counts[:, 0])]
    if decor is not None:
        pools.append((decor.dec_i, decor.counts[:, 1]))
    slots, rows = 0, []
    for i, c in pools:
        below = torch.arange(i.shape[1], device=dev)[None, :] < c[:, None]
        if bool(((i[..., rk.EI_LIVE] > 0) & ~below).any()):
            raise AssertionError("render_suffix: a live slot past its pool's count")
        slots += int(below.sum())
        rows.append(i[..., rk.EI_ROW][below & (i[..., rk.EI_LIVE] > 0)])
    rows = torch.cat(rows).clamp(0, atlas.shape[0] - 1).unique().numel()
    flags = 0 if decor is not None else ent_i.shape[0] * ent_i.shape[1] - slots
    moved = (2 * nbytes(base) + (0 if decor is None else nbytes(decor.counts))
             + (rk.EF_N + rk.EI_N) * 4 * slots + 4 * flags + rows * atlas[0].numel())
    if decor is None:
        ops = slot_ops(ent_f, ent_i, atlas, nz, range(nz), rk, torch, count=count)
    else:
        ops = (slot_ops(ent_f, ent_i, atlas, nz, decor.z_slots, rk, torch,
                        count=decor.counts[:, 0])
               + slot_ops(decor.dec_f, decor.dec_i, atlas, decor.nzd, decor.dz_slots, rk,
                          torch, count=decor.counts[:, 1]))
    return (*bound(moved, ops), f"{moved} bytes, {ops} f32 ops")


def time_frame(x, rk):
    """render_frame and render_frame_reference on ``x`` in turns (kernel,
    plain, kernel): mean ms of the kernel's two readings, the plain
    version's one, and the three readings.  The launches are not
    counted."""
    saved = dict(rk.LAUNCHES)
    k1 = cuda_ms(lambda: rk.render_frame(x), 200)
    p1 = cuda_ms(lambda: rk.render_frame_reference(x), PLAIN_ITERS)
    k2 = cuda_ms(lambda: rk.render_frame(x), 200)
    rk.LAUNCHES.update(saved)
    return (k1 + k2) / 2, p1, f"{k1:.4f}, {p1:.4f}, {k2:.4f}"


def suffix_times(base, ent_f, ent_i, atlas, nz, decor, rk):
    """render_suffix and render_suffix_reference on these inputs in turns
    (kernel, plain, kernel): mean ms of the kernel's two readings, the
    plain version's one, and the three readings.  The launches are not
    counted."""
    saved = dict(rk.LAUNCHES)
    k1 = cuda_ms(lambda: rk.render_suffix(base, ent_f, ent_i, atlas, nz, decor), 200)
    p1 = cuda_ms(lambda: rk.render_suffix_reference(base, ent_f, ent_i, atlas, nz, decor),
                 PLAIN_ITERS)
    k2 = cuda_ms(lambda: rk.render_suffix(base, ent_f, ent_i, atlas, nz, decor), 200)
    rk.LAUNCHES.update(saved)
    return (k1 + k2) / 2, p1, f"{k1:.4f}, {p1:.4f}, {k2:.4f}"


def zero_counts(*mods):
    for mod in mods:
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0


def main(argv=()):
    import numpy as np
    import torch

    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from procgen_tpu_torch import kernels

    only = None
    if argv:
        if len(argv) != 2 or argv[0] != "--only":
            print("usage: chip_smoke.py [--only PHASE,...]", file=sys.stderr)
            return 2
        only = set(argv[1].split(","))
        unknown = only - set(PHASES)
        if unknown:
            print(f"chip_smoke: unknown phases {sorted(unknown)}", file=sys.stderr)
            return 2
    nvcc_ver = subprocess.run(
        [kernels.nvcc_path(), "--version"], capture_output=True, text=True,
        check=True,
    ).stdout.strip().splitlines()[-1]
    card = card_line()
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{nvcc_ver} | {card} | count {torch.cuda.device_count()}")
    dev = torch.device("cuda")

    # the CPU halves of the card-against-CPU runs and of the painter
    # checks, meanwhile
    start_cpu_worker(only)
    start_painter_worker(only)
    try:
        return run_phases(dev, card, np, torch, only)
    finally:
        stop_cpu_worker()


# the phases after the build, in order: the sixteen slices, then memory
# mode, monochrome sprites, generated assets and the gym3 surfaces
PHASES = ("maze", "miner", "coinrun", "fruitbot", "starpilot", "plunder", "leaper",
          "bigfish", "dodgeball", "bossfight", "climber", "ninja", "chaser", "heist",
          "jumper", "caveflyer", "memory", "mono", "genassets", "surfaces")


def run_phases(dev, card, np, torch, only=None):
    """Phases 2 to 22 (with ``only``, the named phases of ``PHASES``; with
    no arguments, all of them).  Prints each phase's wall seconds on a line
    before the kernels line."""
    from procgen_tpu_torch import kernels

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    kernels.load()
    info = kernels.BUILD_INFO
    log("build", f"nvcc {info['seconds']:.2f}s (load {time.perf_counter() - t0:.2f}s) "
        f"{' | '.join(info.get('ptxas', []))}")
    walls = {"build": time.perf_counter() - t0}

    phases = {
        "maze": lambda: maze_phase(dev, card, np, torch),
        "miner": lambda: miner_phase(dev, card, np, torch),
        "coinrun": lambda: coinrun_phase(dev, card, np, torch),
        "fruitbot": lambda: fruitbot_phase(dev, card, np, torch),
        "starpilot": lambda: starpilot_phase(dev, card, np, torch),
        "plunder": lambda: plunder_phase(dev, card, np, torch),
        "leaper": lambda: entity_suffix_phase("leaper", (0, 1, 2), 31, dev, card, np, torch),
        "bigfish": lambda: entity_suffix_phase("bigfish", (0, 1), 37, dev, card, np, torch),
        "dodgeball": lambda: dodgeball_phase(dev, card, np, torch),
        "bossfight": lambda: bossfight_phase(dev, card, np, torch),
        "climber": lambda: climber_phase(dev, card, np, torch),
        "ninja": lambda: ninja_phase(dev, card, np, torch),
        "chaser": lambda: chaser_phase(dev, card, np, torch),
        "heist": lambda: heist_phase(dev, card, np, torch),
        "jumper": lambda: jumper_phase(dev, card, np, torch),
        "caveflyer": lambda: caveflyer_phase(dev, card, np, torch),
        "memory": lambda: [memory_phase(dev, card, np, torch)],
        "mono": lambda: mono_phase(dev, card, np, torch),
        "genassets": lambda: genassets_phase(dev, card, np, torch),
        "surfaces": lambda: surfaces_phase(dev, card, np, torch),
    }
    runs, rows = [], []
    for name in PHASES:
        if only is not None and name not in only:
            continue
        t0 = time.perf_counter()
        out = phases[name]()
        walls[name] = time.perf_counter() - t0
        if name in ("memory", "mono", "genassets", "surfaces"):
            rows += out
        else:
            runs.append((name, out[0]))
            rows.append(out[1])

    # -- 21. profile: after every timed phase --------------------------------
    t0 = time.perf_counter()
    for name, run in runs:
        profile_slice(name, *run, np, torch)
    walls["profile"] = time.perf_counter() - t0

    # -- 22. result ----------------------------------------------------------
    log("walls", "phase wall seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
        + f"; total {time.perf_counter() - T_START:.1f}")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def _game(name, mode):
    from procgen_tpu_torch.core.constants import INT32_MAX
    from procgen_tpu_torch.core.options import GameOptions
    from procgen_tpu_torch.games.registry import make_game

    game = make_game(name, GameOptions(distribution_mode=mode))
    game.level_seed_low, game.level_seed_high = 0, INT32_MAX
    return game


def run_slice(name, dev, card, np, torch, warm=WARM_STEPS, timed=TIMED_STEPS):
    """The main path of one game: ``make_env_fns(4096, name)``, ``warm``
    warm-up and ``timed`` timed steps (20 and 100 unless given), launch
    counts zeroed just before and read just after.  Returns (carry,
    launches, step, ms a timed step)."""
    from procgen_tpu_torch.entry import make_env_fns
    from procgen_tpu_torch.render import render_kernel as rk

    init, step, seeds = make_env_fns(NUM_ENVS, name, device=dev)
    total = warm + timed
    actions = torch.as_tensor(
        np.random.RandomState(0).randint(0, 15, size=(total, NUM_ENVS)),
        dtype=torch.int32, device=dev,
    )
    t0 = time.perf_counter()
    carry = init(seeds)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    zero_counts(rk)
    for t in range(warm):
        carry, obs, rew, done = step(carry, actions[t])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dones = []
    for t in range(warm, total):
        carry, obs, rew, done = step(carry, actions[t])
        dones.append(done)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(rk.LAUNCHES)
    ends = float(torch.stack(dones).float().mean())
    if obs.dtype != torch.uint8 or tuple(obs.shape) != (NUM_ENVS, 64, 64, 3) \
            or obs.device.type != dev.type:
        raise AssertionError(f"bad obs {obs.dtype} {tuple(obs.shape)} {obs.device}")
    if not (torch.isfinite(rew).all() and rew.shape == (NUM_ENVS,)):
        raise AssertionError("bad rewards")
    rate = timed * NUM_ENVS / dt
    wall_ms = dt / timed * 1e3
    log(name, f"slice: {rate:.1f} env-steps/s ({wall_ms:.2f} ms/step, "
        f"{NUM_ENVS} envs, {timed} timed steps after {warm}; init "
        f"{t_init:.2f}s) on {card}; launches {launches} in {total} steps; "
        f"{ends * 100:.3f}% of the envs end an episode a timed step")
    split, ops = step_split(carry, actions[:SPLIT_STEPS], name, torch)
    log(name, "step split (synchronised, ms/step): " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()) + "; torch operations "
        "dispatched (a count): " + ", ".join(f"{k} {v}" for k, v in ops.items())
        + f"; one env_reset of {RESET_CHUNK} envs, synchronised: "
        f"{reset_ms(carry, name, torch):.3f} ms")
    return carry, launches, step, wall_ms


def profile_slice(name, carry, step, wall_ms, np, torch):
    """``PROFILE_STEPS`` more steps of a slice under ``torch.profiler``:
    device records and device ms a step, the device busy share (device ms
    over the slice's timed ms a step) and the five largest kernels.  Run after
    every timed phase: the host dispatch stays slower once the profiler
    has run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    actions = torch.as_tensor(
        np.random.RandomState(4).randint(0, 15, size=(PROFILE_STEPS, NUM_ENVS)),
        dtype=torch.int32, device=carry.valid.device,
    )
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for a in actions:
            carry, *_ = step(carry, a)
        torch.cuda.synchronize()
    # the raw trace's device records: building the profiler's event tree
    # (``prof.events()``) would take seconds a slice for the same numbers
    device = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    if not device:
        raise AssertionError(f"{name}: the profiler saw no device activity")
    by_name = collections.Counter()
    for e in device:
        label = e.name().replace("(anonymous namespace)::", "").split("(")[0][:100]
        by_name[label] += e.duration_ns() / 1e6 / PROFILE_STEPS
    device_ms = sum(by_name.values())
    log(name, f"profile of the {PROFILE_STEPS} steps after the slice: "
        f"{len(device) / PROFILE_STEPS:.1f} device records and {device_ms:.3f} "
        f"device ms a step, busy share {device_ms / wall_ms:.4f} of the timed "
        f"step ({time.perf_counter() - t0:.1f} s with the profiler's "
        f"processing); largest (ms/step): "
        + "; ".join(f"{k} {v:.3f}" for k, v in by_name.most_common(5)))


# the card-against-CPU runs, in the order the phases make them: (game,
# every state leaf too, ``ProcgenGym3Env`` options, easy mode unless they
# say otherwise); 64 envs, 50 steps each
GEN = {"use_generated_assets": True}
MEMORY = {"distribution_mode": "memory"}
# ``LIBM``: the CPU half of starpilot's libm check (``libm_outputs``)
LIBM = ("libm", False, {})
# ``SURFACES``: the CPU half of the surfaces phase (``surface_outputs``)
SURFACES = ("surfaces", False, {})
CPU_RUNS = (("maze", False, {}), ("miner", False, {}), ("coinrun", False, {}),
            ("fruitbot", False, {}), LIBM, ("starpilot", True, {}), ("plunder", True, {}),
            ("leaper", True, {}), ("bigfish", True, {}), ("dodgeball", True, {}),
            ("bossfight", True, {}), ("climber", True, {}), ("ninja", True, {}),
            ("chaser", True, {}), ("heist", True, {}), ("jumper", True, {}),
            ("caveflyer", True, {}), ("maze", True, MEMORY), ("maze", True, GEN),
            ("coinrun", True, GEN), SURFACES)


def run_phase(run):
    """The phase of ``PHASES`` that makes a run of ``CPU_RUNS``."""
    name, _, opts = run
    if run == LIBM:
        return "starpilot"
    if run == SURFACES:
        return "surfaces"
    if opts.get("distribution_mode") == "memory":
        return "memory"
    return "genassets" if opts.get("use_generated_assets") else name
CPU_STEPS = 50
CPU_THREADS = 4
_CPU = {}  # the CPU worker: its process, queue, the runs it sent, the next run


def gym_run(name, device, states, opts, np):
    """A 64-env ProcgenGym3Env (``opts``: its options) on ``device`` for
    ``CPU_STEPS`` steps of seeded actions.  Returns (per step the obs,
    rewards, firsts and every info field, latents included; the info keys;
    with ``states``, every leaf of the last states, else None)."""
    from procgen_tpu_torch import ProcgenGym3Env
    from procgen_tpu_torch.bridge import state_to_numpy

    env = ProcgenGym3Env(num=64, env_name=name, rand_seed=0, device=device,
                         **{"distribution_mode": "easy", **opts})
    arng = np.random.RandomState(3)
    out = []
    for _ in range(CPU_STEPS):
        env.act(arng.randint(0, 15, size=64).astype(np.int32))
        rew, obs, first = env.observe()
        inf = env._vec._info_impl(env._vec.states)
        out.append([obs["rgb"], rew, first] + [v.cpu().numpy() for _, v in sorted(inf.items())])
    return out, sorted(inf), _leaves(state_to_numpy(env._vec.states)) if states else None


def cpu_worker(queue, runs):
    """The CPU halves of ``runs`` (of ``CPU_RUNS``), in order, each put on
    ``queue`` as it ends.  It runs in a process of its own, so that the
    card's phases do not wait for the CPU."""
    import numpy as np
    import torch

    torch.set_num_threads(CPU_THREADS)
    for i, (name, states, opts) in enumerate(runs):
        t0 = time.perf_counter()
        if (name, states, opts) == LIBM:
            run = [t.numpy() for t in libm_outputs("cpu", np, torch)]
        elif (name, states, opts) == SURFACES:
            run = surface_outputs("cpu", np)
        else:
            run = gym_run(name, "cpu", states, opts, np)
        queue.put((i, run, time.perf_counter() - t0))


def start_cpu_worker(only=None):
    """The CPU worker, for the runs of the phases in ``only`` (all when
    None)."""
    import multiprocessing

    runs = tuple(r for r in CPU_RUNS if only is None or run_phase(r) in only)
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=cpu_worker, args=(queue, runs), daemon=True)
    proc.start()
    _CPU.update(proc=proc, queue=queue, done={}, next=0, runs=runs)


def stop_cpu_worker():
    """Stop the CPU worker and the painter worker."""
    for proc in (_CPU.get("proc"), _PAINTER.get("proc")):
        if proc is not None:
            if proc.is_alive():
                proc.terminate()
            proc.join()


def cpu_run(i):
    """Run ``i`` of ``CPU_RUNS`` from the worker (waited for), and the
    seconds the worker took for it and this process waited."""
    import queue

    done, proc = _CPU["done"], _CPU["proc"]
    t0 = time.perf_counter()
    while i not in done:
        try:
            k, run, secs = _CPU["queue"].get(timeout=5)
            done[k] = (run, secs)
        except queue.Empty:
            if not proc.is_alive():
                raise RuntimeError(f"the CPU worker ended (exit code {proc.exitcode}) "
                                   f"before run {i} of {len(_CPU['runs'])}")
    run, secs = done.pop(i)
    return run, secs, time.perf_counter() - t0


def next_cpu_run(run):
    """The index in the worker's runs of ``run``, the next one due."""
    i = _CPU["next"]
    runs = _CPU["runs"]
    if i >= len(runs) or runs[i] != run:
        raise AssertionError(f"card-against-CPU run {i} is {runs[i:i + 1]}, not {run}")
    _CPU["next"] = i + 1
    return i


def gpu_matches_cpu(name, np, torch, states=False, **opts):
    """The next of the worker's ``CPU_RUNS`` (this game, these options) on
    the card, against the CPU worker's run of it: obs, rewards, firsts and
    every info field (latents included) equal at each of the
    ``CPU_STEPS`` steps; with ``states``, every leaf of the last states
    too."""
    i = next_cpu_run((name, states, opts))
    gpu, keys, g_leaves = gym_run(name, "cuda", states, opts, np)
    (cpu, c_keys, c_leaves), secs, waited = cpu_run(i)
    if c_keys != keys or len(cpu) != len(gpu):
        raise AssertionError(f"{name}: the CPU run has info {c_keys}, {len(cpu)} steps")
    for t, (xs, ys) in enumerate(zip(gpu, cpu)):
        for x, y in zip(xs, ys):
            if x.dtype != y.dtype or not np.array_equal(x, y):
                raise AssertionError(f"{name}: GPU and CPU runs differ at step {t}")
    log(name, f"card-against-CPU run {i}: the CPU worker's run took {secs:.1f} s, "
        f"waited for {waited:.1f} s")
    if states:
        if sorted(c_leaves) != sorted(g_leaves):
            raise AssertionError(f"{name}: GPU and CPU states have other leaves")
        for k, v in g_leaves.items():
            w = c_leaves[k]
            if v.dtype != w.dtype or not np.array_equal(v, w, equal_nan=v.dtype.kind == "f"):
                raise AssertionError(f"{name}: GPU and CPU states differ in {k}")
        return keys + [f"{len(g_leaves)} state leaves"]
    return keys


def _leaves(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, pre + k + "."))
        elif v is not None:
            out[pre + k] = v
    return out


def replay_on_card(name, folder="conformance"):
    from procgen_tpu_torch.conformance import replay

    with open(os.path.join(ROOT, "tests", "data", folder, f"{name}.json")) as f:
        rec = json.load(f)
    res = replay(rec, device="cuda")
    if res["first_divergence"] is not None:
        raise AssertionError(f"{name} replay diverged: {res['first_divergence']}")
    return res["checked"]


def maze_phase(dev, card, np, torch):
    from procgen_tpu_torch.render import render_kernel as rk

    maze = _game("maze", 0)
    plan = rk.get_plan(maze)
    atlas = plan.atlas(dev)
    nz = len(plan.z_levels)

    # kernel vs plain version on real and made-up inputs
    from procgen_tpu_torch.entry import make_env_fns

    init, step, seeds = make_env_fns(NUM_ENVS, "maze", device=dev)
    carry = init(seeds)
    rng = np.random.RandomState(1)
    for _ in range(PRE_STEPS):
        acts = torch.as_tensor(rng.randint(0, 15, size=NUM_ENVS), device=dev)
        carry, obs, rew, done = step(carry, acts)
    ent_f, ent_i = rk.prep(plan, carry.states)
    base = carry.states.frame.contiguous()
    got = rk.render_suffix(base, ent_f, ent_i, atlas, nz)
    want = rk.render_suffix_reference(base, ent_f, ent_i, atlas, nz)
    torch.cuda.synchronize()
    err_real = int((got.int() - want.int()).abs().max())
    live = int(ent_i[..., rk.EI_LIVE].sum())
    if err_real != 0:
        raise AssertionError(f"render_suffix != plain on maze states (max err {err_real})")
    sf, si = rk.synthetic_slots(NUM_ENVS, 8, atlas.shape[0], seed=0)
    sbase = torch.as_tensor(
        np.random.RandomState(2).randint(0, 256, (NUM_ENVS, 64, 64, 3)).astype(np.uint8),
        device=dev,
    )
    sf, si = sf.to(dev), si.to(dev)
    got_s = rk.render_suffix(sbase, sf, si, atlas, 2)
    want_s = rk.render_suffix_reference(sbase, sf, si, atlas, 2)
    torch.cuda.synchronize()
    err_syn = int((got_s.int() - want_s.int()).abs().max())
    if err_syn != 0:
        raise AssertionError(f"render_suffix != plain on made-up slots (max err {err_syn})")
    changed = float((got_s != sbase).any(dim=-1).float().mean())
    # the edge cases at 112 slots (masks of four words)
    ef_e, ei_e = rk.synthetic_slots(NUM_ENVS, 112, atlas.shape[0], seed=13, edges=True)
    err_syn = max(err_syn, suffix_check(sbase, ef_e.to(dev), ei_e.to(dev), atlas, 2,
                                        None, "edge-case slots, cap 112", rk, torch))
    del ef_e, ei_e
    log("maze", f"render_suffix byte-equal: {NUM_ENVS} maze states ({live} live "
        f"slots), {NUM_ENVS}x8 made-up slots ({changed:.3f} of pixels "
        f"painted) and {NUM_ENVS}x112 edge-case slots; max_abs_err "
        f"{max(err_real, err_syn)}")
    del carry, obs

    # the main path
    carry, launches, step, wall_ms = run_slice("maze", dev, card, np, torch)
    total = WARM_STEPS + TIMED_STEPS
    if launches["render_suffix"] != total or launches["render_frame"] != 0:
        raise AssertionError(f"maze: launches {launches} in {total} steps")

    # the kernel's time against the plain version's
    ent_f, ent_i = rk.prep(plan, carry.states)
    base = carry.states.frame.contiguous()
    saved = dict(rk.LAUNCHES)
    k1 = cuda_ms(lambda: rk.render_suffix(base, ent_f, ent_i, atlas, nz), 200)
    p1 = cuda_ms(lambda: rk.render_suffix_reference(base, ent_f, ent_i, atlas, nz), 20)
    k2 = cuda_ms(lambda: rk.render_suffix(base, ent_f, ent_i, atlas, nz), 200)
    p2 = cuda_ms(lambda: rk.render_suffix_reference(base, ent_f, ent_i, atlas, nz), 20)
    rk.LAUNCHES.update(saved)
    kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    moved = nbytes(base, ent_f, ent_i, atlas) + nbytes(base)
    ops = slot_ops(ent_f, ent_i, atlas, nz, range(nz), rk, torch)
    b_ms, b_by = bound(moved, ops)
    log("maze", f"render_suffix at N={NUM_ENVS}: kernel {kernel_ms:.4f} ms "
        f"({k1:.4f}, {k2:.4f}), plain torch {plain_ms:.4f} ms ({p1:.4f}, {p2:.4f}); "
        f"bound {b_ms:.4f} ms ({b_by}; {moved} bytes, {ops} f32 ops) on {card}; "
        f"<false> instance: {occupancy(rk.suffix_occupancy(ent_f.shape[1], 0))}")

    keys = gpu_matches_cpu("maze", np, torch)
    checked = replay_on_card("maze_easy")
    log("maze", f"64 envs x 50 steps: GPU and CPU bit-equal (obs, rewards, "
        f"firsts, {', '.join(keys)}); maze_easy replay exact ({checked} steps)")
    return (carry, step, wall_ms), {
        "name": "render_suffix",
        "path": "maze",
        "route": "cuda",
        "source": "procgen_tpu_torch/csrc/render_suffix.cu",
        "replaces": "procgen_tpu/render/pallas_kernel.py:1136",
        "launches": launches["render_suffix"],
        "max_abs_err": max(err_real, err_syn),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }


def frame_check(x, what, rk, torch):
    """render_frame against render_frame_reference on ``x``; max abs err."""
    got = rk.render_frame(x)
    want = rk.render_frame_reference(x)
    torch.cuda.synchronize()
    err = int((got.int() - want.int()).abs().max())
    if err != 0:
        raise AssertionError(f"render_frame != plain on {what} (max err {err})")
    return err


def occupancy(d):
    """A kernel instance's resources, from ``rk.frame_occupancy`` or
    ``rk.suffix_occupancy``, as a log phrase."""
    return (f"{d['registers']} registers, {d['spill_bytes']} spill bytes a thread, "
            f"{d['smem_bytes']} B of shared memory a block, {d['blocks_per_sm']} "
            f"blocks an SM")


def edge_frame_check(plan, cap, dcap, seed, rk, torch, bg_mode=None, bg_atlas=None):
    """render_frame against its plain version on the edge-case slots
    (``synthetic_frame_inputs(edges=True)``) at the given caps, with the
    plan's window and atlases; max abs err."""
    dev = torch.device("cuda")
    x = rk.synthetic_frame_inputs(
        NUM_ENVS, plan.NC, cap, plan.on("grid", dev),
        plan.on("bg", dev) if bg_atlas is None else bg_atlas, plan.atlas(dev),
        plan.grid_opaque, seed=seed, dcap=dcap,
        bg_mode=plan.bg_mode if bg_mode is None else bg_mode, edges=True,
    ).to(dev)
    return frame_check(x, f"edge-case slots, caps {cap} + {dcap}", rk, torch)


def miner_phase(dev, card, np, torch):
    from procgen_tpu_torch.core import lifecycle
    from procgen_tpu_torch.entry import make_env_fns
    from procgen_tpu_torch.render import render_kernel as rk

    # kernel vs plain version: easy after PRE_STEPS steps, hard, made-up
    init, step, seeds = make_env_fns(NUM_ENVS, "miner", device=dev)
    carry = init(seeds)
    rng = np.random.RandomState(1)
    for _ in range(PRE_STEPS):
        acts = torch.as_tensor(rng.randint(0, 15, size=NUM_ENVS), device=dev)
        carry, obs, rew, done = step(carry, acts)
    easy = _game("miner", 0)
    plan = rk.get_plan(easy)
    x_easy = rk.prep_frame(plan, carry.states)
    err = frame_check(x_easy, "miner-easy states", rk, torch)
    del carry, obs

    hard = _game("miner", 1)
    s = lifecycle.env_reset(hard, lifecycle.initial_state(hard, seeds))
    for _ in range(5):
        acts = torch.as_tensor(rng.randint(0, 15, size=NUM_ENVS), device=dev)
        s, _ = lifecycle.env_step(hard, s, acts)
    x_hard = rk.prep_frame(rk.get_plan(hard), s)
    err = max(err, frame_check(x_hard, "miner-hard states", rk, torch))
    del s

    x_syn = rk.synthetic_frame_inputs(
        NUM_ENVS, plan.NC, 8, plan.on("grid", dev), plan.on("bg", dev),
        plan.atlas(dev), plan.grid_opaque, seed=0,
    ).to(dev)
    err = max(err, frame_check(x_syn, "made-up inputs", rk, torch))
    cells = float(((x_syn.cell5[:, 3] > 0.5) & (x_syn.gtab >= x_syn.grid_opaque)).float().mean())
    del x_syn
    err = max(err, edge_frame_check(plan, 112, 0, 15, rk, torch))
    log("miner", f"render_frame byte-equal: {NUM_ENVS} miner-easy states after {PRE_STEPS} "
        f"steps, {NUM_ENVS} miner-hard states (NC {x_hard.gtab.shape[1]}, sA "
        f"{x_hard.grid_atlas.shape[1]}), {NUM_ENVS} made-up envs ({cells:.3f} of "
        f"cells valid and uncovered), {NUM_ENVS} envs of edge-case slots (cap 112); "
        f"max_abs_err {err}")

    # the main path
    carry, launches, step, wall_ms = run_slice("miner", dev, card, np, torch)
    total = WARM_STEPS + TIMED_STEPS
    if launches["render_frame"] != total or launches["render_suffix"] != 0:
        raise AssertionError(f"miner: launches {launches} in {total} steps")

    # the kernel's time against the plain version's, on the slice's states
    x = rk.prep_frame(plan, carry.states)
    kernel_ms, plain_ms, readings = time_frame(x, rk)
    saved = dict(rk.LAUNCHES)
    kh = cuda_ms(lambda: rk.render_frame(x_hard), 200)
    rk.LAUNCHES.update(saved)
    b_ms, b_by, b_work = frame_bound(x, rk, torch)
    bh_ms, bh_by, bh_work = frame_bound(x_hard, rk, torch)
    log("miner", f"render_frame at N={NUM_ENVS}: easy kernel {kernel_ms:.4f} ms, "
        f"plain torch {plain_ms:.4f} ms (kernel, plain, kernel: {readings}), "
        f"bound {b_ms:.4f} ms ({b_by}; {b_work}); hard kernel {kh:.4f} ms, bound "
        f"{bh_ms:.4f} ms ({bh_by}; {bh_work}) on {card}; <BG_CROP> instance: "
        f"{occupancy(rk.frame_occupancy(x))}")

    keys = gpu_matches_cpu("miner", np, torch)
    checked = replay_on_card("miner_easy")
    log("miner", f"64 envs x 50 steps: GPU and CPU bit-equal (obs, rewards, "
        f"firsts, {', '.join(keys)}); miner_easy replay exact ({checked} steps)")
    return (carry, step, wall_ms), frame_row("miner", launches, err, kernel_ms,
                                             plain_ms, b_ms, b_by)


def frame_row(path, launches, err, kernel_ms, plain_ms, b_ms, b_by):
    """The kernels-line entry of ``render_frame`` on one path."""
    return {
        "name": "render_frame",
        "path": path,
        "route": "cuda",
        "source": "procgen_tpu_torch/csrc/render_frame.cu",
        "replaces": "procgen_tpu/render/pallas_kernel.py:1136",
        "launches": launches["render_frame"],
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }


def coinrun_phase(dev, card, np, torch):
    from procgen_tpu_torch.core import lifecycle
    from procgen_tpu_torch.core.constants import INT32_MAX
    from procgen_tpu_torch.core.options import GameOptions
    from procgen_tpu_torch.entry import make_env_fns
    from procgen_tpu_torch.games.coinrun import Coinrun
    from procgen_tpu_torch.render import render_kernel as rk

    def centred(mode):
        game = Coinrun(GameOptions(distribution_mode=mode, center_agent=True))
        game.level_seed_low, game.level_seed_high = 0, INT32_MAX
        return game

    # kernel vs plain version: easy after PRE_STEPS steps under both cameras,
    # hard, made-up with both pools full
    init, step, seeds = make_env_fns(NUM_ENVS, "coinrun", device=dev)
    carry = init(seeds)
    rng = np.random.RandomState(1)
    for _ in range(PRE_STEPS):
        acts = torch.as_tensor(rng.randint(0, 15, size=NUM_ENVS), device=dev)
        carry, obs, rew, done = step(carry, acts)
    world = rk.get_plan(_game("coinrun", 0))
    cplan = rk.get_plan(centred(0))
    x_world = rk.prep_frame(world, carry.states)
    x_centred = rk.prep_frame(cplan, carry.states)
    err = frame_check(x_world, "coinrun-easy states, whole-world camera", rk, torch)
    err = max(err, frame_check(x_centred, "coinrun-easy states, centred", rk, torch))
    trails = int(carry.states.decor.count.sum())
    del carry, obs, x_world

    hard = centred(1)
    s = lifecycle.env_reset(hard, lifecycle.initial_state(hard, seeds))
    for _ in range(20):
        acts = torch.as_tensor(rng.randint(0, 15, size=NUM_ENVS), device=dev)
        s, _ = lifecycle.env_step(hard, s, acts)
    x_hard = rk.prep_frame(rk.get_plan(hard), s)
    err = max(err, frame_check(x_hard, "coinrun-hard states", rk, torch))
    trails_hard = int(s.decor.count.sum())
    del s

    game = cplan.game
    x_syn = rk.synthetic_frame_inputs(
        NUM_ENVS, cplan.NC, game.ENT_CAP, cplan.on("grid", dev), cplan.on("bg", dev),
        cplan.atlas(dev), cplan.grid_opaque, seed=3, dcap=game.DECOR_CAP,
    ).to(dev)
    err = max(err, frame_check(x_syn, "made-up inputs, both pools full", rk, torch))
    del x_syn
    err = max(err, edge_frame_check(world, game.ENT_CAP, game.DECOR_CAP, 17, rk, torch))
    log("coinrun", f"render_frame byte-equal: {NUM_ENVS} coinrun-easy states after {PRE_STEPS} "
        f"steps ({trails} live trails) under the whole-world camera (NC {world.NC}, "
        f"sA {world.sA}) and the centred one (NC {cplan.NC}, sA {cplan.sA}), "
        f"{NUM_ENVS} coinrun-hard states after 20 steps ({trails_hard} live trails), "
        f"{NUM_ENVS} made-up envs (cap {game.ENT_CAP}, dcap {game.DECOR_CAP}), "
        f"{NUM_ENVS} envs of edge-case slots at those caps, whole-world window; "
        f"max_abs_err {err}")
    del x_hard

    # the main path
    carry, launches, step, wall_ms = run_slice("coinrun", dev, card, np, torch)
    total = WARM_STEPS + TIMED_STEPS
    if launches["render_frame"] != total or launches["render_suffix"] != 0:
        raise AssertionError(f"coinrun: launches {launches} in {total} steps")

    # the kernel's time against the plain version's, on the slice's states
    # under both cameras
    x = rk.prep_frame(world, carry.states)
    kernel_ms, plain_ms, readings = time_frame(x, rk)
    b_ms, b_by, b_work = frame_bound(x, rk, torch)
    xc = rk.prep_frame(cplan, carry.states)
    kc_ms, pc_ms, creadings = time_frame(xc, rk)
    bc_ms, bc_by, bc_work = frame_bound(xc, rk, torch)
    log("coinrun", f"render_frame at N={NUM_ENVS} ({int(carry.states.decor.count.sum())} "
        f"live trails): whole-world camera kernel {kernel_ms:.4f} ms, plain torch "
        f"{plain_ms:.4f} ms (kernel, plain, kernel: {readings}), bound "
        f"{b_ms:.4f} ms ({b_by}; {b_work}); centred kernel {kc_ms:.4f} ms, plain "
        f"{pc_ms:.4f} ms ({creadings}), bound {bc_ms:.4f} ms ({bc_by}; {bc_work}) "
        f"on {card}; <BG_CROP> instance, whole world: {occupancy(rk.frame_occupancy(x))}; "
        f"centred: {occupancy(rk.frame_occupancy(xc))}")
    del x, xc

    # the gym3 surface at full width: act + observe, the centred camera
    gym_centred("coinrun", card, np, torch)

    keys = gpu_matches_cpu("coinrun", np, torch)
    checked = replay_on_card("coinrun_easy")
    log("coinrun", f"64 envs x 50 steps, centred: GPU and CPU bit-equal (obs, "
        f"rewards, firsts, {', '.join(keys)}); coinrun_easy replay exact "
        f"({checked} steps)")
    return (carry, step, wall_ms), frame_row("coinrun", launches, err, kernel_ms,
                                             plain_ms, b_ms, b_by)


def gym_centred(name, card, np, torch, timed=GYM_TIMED_STEPS, mode="easy"):
    """The gym3 surface at full width, act + observe, the centred camera
    (``ProcgenGym3Env``'s default) in distribution mode ``mode``:
    ``timed`` timed steps after 10 (``GYM_TIMED_STEPS`` unless given);
    returns the render_frame launches in the timed steps."""
    from procgen_tpu_torch import ProcgenGym3Env
    from procgen_tpu_torch.render import render_kernel as rk

    env = ProcgenGym3Env(num=NUM_ENVS, env_name=name, distribution_mode=mode,
                         rand_seed=0, device="cuda")
    arng = np.random.RandomState(5)
    acts = arng.randint(0, 15, size=(10 + timed, NUM_ENVS)).astype(np.int32)
    for a in acts[:10]:
        env.act(a)
        env.observe()
    before = rk.LAUNCHES["render_frame"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in acts[10:]:
        env.act(a)
        rew_, obs_, first_ = env.observe()
    dt = time.perf_counter() - t0
    n_gym = rk.LAUNCHES["render_frame"] - before
    if obs_["rgb"].shape != (NUM_ENVS, 64, 64, 3) or n_gym != timed:
        raise AssertionError(f"gym3 {name}: obs {obs_['rgb'].shape}, {n_gym} launches")
    log(name, f"ProcgenGym3Env centred ({mode}): {timed * NUM_ENVS / dt:.1f} "
        f"env-steps/s ({dt / timed * 1e3:.2f} ms per act+observe, "
        f"{NUM_ENVS} envs, {timed} timed steps after 10, obs copied to "
        f"the host) on {card}; {n_gym} render_frame launches")
    return n_gym


def fruitbot_phase(dev, card, np, torch):
    from procgen_tpu_torch.core import lifecycle
    from procgen_tpu_torch.core.constants import INT32_MAX
    from procgen_tpu_torch.core.options import GameOptions
    from procgen_tpu_torch.entry import make_env_fns
    from procgen_tpu_torch.games.fruitbot import Fruitbot
    from procgen_tpu_torch.render import render_kernel as rk

    def game_of(mode, centred):
        game = Fruitbot(GameOptions(distribution_mode=mode, center_agent=centred))
        game.level_seed_low, game.level_seed_high = 0, INT32_MAX
        return game

    # kernel vs plain version: easy after PRE_STEPS steps under both cameras,
    # hard, made-up tiled rects
    init, step, seeds = make_env_fns(NUM_ENVS, "fruitbot", device=dev)
    carry = init(seeds)
    rng = np.random.RandomState(1)
    for _ in range(PRE_STEPS):
        acts = torch.as_tensor(rng.randint(0, 15, size=NUM_ENVS), device=dev)
        carry, obs, rew, done = step(carry, acts)
    world = rk.get_plan(game_of(0, False))
    cplan = rk.get_plan(game_of(0, True))
    x_world = rk.prep_frame(world, carry.states)
    x_centred = rk.prep_frame(cplan, carry.states)
    err = frame_check(x_world, "fruitbot-easy states, whole-world camera", rk, torch)
    err = max(err, frame_check(x_centred, "fruitbot-easy states, centred", rk, torch))
    live = int(carry.states.ents.count.sum())
    tile_h = float(x_world.sf[0, rk.SF_TILEH])
    del carry, obs, x_world, x_centred

    hard = game_of(1, False)
    s = lifecycle.env_reset(hard, lifecycle.initial_state(hard, seeds))
    for _ in range(20):
        acts = torch.as_tensor(rng.choice([1, 4, 7, 9], size=NUM_ENVS), device=dev)
        s, _ = lifecycle.env_step(hard, s, acts)
    x_hard = rk.prep_frame(rk.get_plan(hard), s)
    err = max(err, frame_check(x_hard, "fruitbot-hard states", rk, torch))
    live_hard = int(s.ents.count.sum())
    del s

    x_syn = rk.synthetic_frame_inputs(
        NUM_ENVS, cplan.NC, 24, cplan.on("grid", dev), cplan.on("bg", dev),
        cplan.atlas(dev), cplan.grid_opaque, seed=5, bg_mode=rk.BG_TILED,
    ).to(dev)
    err = max(err, frame_check(x_syn, "made-up tiled inputs", rk, torch))
    del x_syn
    err = max(err, edge_frame_check(world, world.game.ENT_CAP, 0, 19, rk, torch))
    log("fruitbot", f"render_frame byte-equal: {NUM_ENVS} fruitbot-easy states after "
        f"{PRE_STEPS} steps ({live} live slots) under the whole-world camera (NC {world.NC}, "
        f"tile height {tile_h:.6f} px) "
        f"and the centred one (NC {cplan.NC}), {NUM_ENVS} fruitbot-hard states after "
        f"20 steps ({live_hard} live slots), {NUM_ENVS} made-up tiled envs, "
        f"{NUM_ENVS} tiled envs of edge-case slots (cap {world.game.ENT_CAP}); "
        f"max_abs_err {err}")

    # the main path
    carry, launches, step, wall_ms = run_slice("fruitbot", dev, card, np, torch)
    total = WARM_STEPS + TIMED_STEPS
    if launches["render_frame"] != total or launches["render_suffix"] != 0:
        raise AssertionError(f"fruitbot: launches {launches} in {total} steps")

    # the kernel's time against the plain version's: the slice's states
    # under both cameras, and the hard states
    x = rk.prep_frame(world, carry.states)
    kernel_ms, plain_ms, readings = time_frame(x, rk)
    b_ms, b_by, b_work = frame_bound(x, rk, torch)
    xc = rk.prep_frame(cplan, carry.states)
    kc_ms, pc_ms, creadings = time_frame(xc, rk)
    bc_ms, bc_by, bc_work = frame_bound(xc, rk, torch)
    kh_ms, ph_ms, hreadings = time_frame(x_hard, rk)
    bh_ms, bh_by, bh_work = frame_bound(x_hard, rk, torch)
    log("fruitbot", f"render_frame at N={NUM_ENVS} ({int(carry.states.ents.count.sum())} "
        f"live slots): whole-world camera kernel {kernel_ms:.4f} ms, plain torch "
        f"{plain_ms:.4f} ms (kernel, plain, kernel: {readings}), bound "
        f"{b_ms:.4f} ms ({b_by}; {b_work}); centred kernel {kc_ms:.4f} ms, plain "
        f"{pc_ms:.4f} ms ({creadings}), bound {bc_ms:.4f} ms ({bc_by}; {bc_work}); "
        f"hard kernel {kh_ms:.4f} ms, plain {ph_ms:.4f} ms ({hreadings}), bound "
        f"{bh_ms:.4f} ms ({bh_by}; {bh_work}) on {card}; <BG_TILED> instance, whole "
        f"world: {occupancy(rk.frame_occupancy(x))}")
    del x, xc, x_hard

    gym_centred("fruitbot", card, np, torch)
    keys = gpu_matches_cpu("fruitbot", np, torch)
    checked = replay_on_card("fruitbot_easy")
    log("fruitbot", f"64 envs x 50 steps, centred: GPU and CPU bit-equal (obs, "
        f"rewards, firsts, {', '.join(keys)}); fruitbot_easy replay exact "
        f"({checked} steps)")
    return (carry, step, wall_ms), frame_row("fruitbot", launches, err, kernel_ms,
                                             plain_ms, b_ms, b_by)


def libm_outputs(device, np, torch):
    """``core/libm.py`` and the C++ double expressions of a draw on
    ``device``: the trig of starpilot's step on seeded inputs, bigfish's
    fish radius and starpilot's spawner products at every distinct
    rand01 value.  Returns the outputs, a flat list of tensors."""
    from procgen_tpu_torch.core import libm
    from procgen_tpu_torch.games.bigfish import fish_radius
    from tools.draw_domains import distinct_rand01, spawner_speeds

    rng = np.random.RandomState(11)
    n = 1 << 22
    words = rng.randint(0, 2**32, n, dtype=np.uint64).astype(np.float32)
    reset = (words * np.float32(2.0**-32) - np.float32(0.5)) * np.float32(np.pi / 2)
    wide = rng.uniform(-119.9, 119.9, n // 4).astype(np.float32)
    # glibc's reduce_large: |x| from 120 to 2^127, log-uniform, both signs
    large = (np.exp2(rng.uniform(np.log2(120.0), 127.99, n // 4))
             * rng.choice([-1.0, 1.0], n // 4)).astype(np.float32)
    ys = np.concatenate([rng.uniform(-16, 16, n // 2), rng.uniform(-1, 1, n // 2)])
    xs = np.concatenate([rng.uniform(-16, 16, n // 2), rng.uniform(-1, 1, n // 2)])
    cases = [(libm.sincosf, (reset,)), (libm.sincosf, (wide,)), (libm.sincosf, (large,)),
             (libm.atan2f, (ys.astype(np.float32), xs.astype(np.float32)))]
    r01 = distinct_rand01()
    theta = torch.unique(((r01.double() - 0.5) * (float(np.float32(np.pi)) / 2)).float())
    cases.append((fish_radius, (r01.numpy(),)))
    cases += [(libm.sincos_times, (theta.numpy(), np.full(theta.shape, v, np.float32)))
              for v in spawner_speeds()]
    del r01, theta
    out = []
    for fn, args in cases:
        got = fn(*(torch.from_numpy(a).to(device) for a in args))
        out += list(got) if isinstance(got, tuple) else [got]
    return out


def libm_check(dev, np, torch):
    """``libm_outputs`` on the card against the CPU worker's, bit for bit
    and no NaN.  Returns the outputs' count."""
    i = next_cpu_run(LIBM)
    gpu = [g.cpu() for g in libm_outputs(dev, np, torch)]
    cpu, secs, waited = cpu_run(i)
    if len(cpu) != len(gpu):
        raise AssertionError(f"libm: {len(gpu)} outputs on the card, {len(cpu)} on the CPU")
    total = 0
    for c, g in zip(cpu, gpu):
        c = torch.from_numpy(c)
        differ = int((c.view(torch.int32) != g.view(torch.int32)).sum()) \
            if c.shape == g.shape and c.dtype == g.dtype else -1
        if differ or bool(torch.isnan(c).any()):
            raise AssertionError(f"libm: card and CPU differ on {differ} of {c.numel()} "
                                 f"outputs (-1: shapes), or NaN for a finite input")
        total += c.numel()
    log("starpilot", f"libm check: the CPU worker's half took {secs:.1f} s, waited for "
        f"{waited:.1f} s")
    return total


def starpilot_phase(dev, card, np, torch):
    from procgen_tpu_torch.core import lifecycle
    from procgen_tpu_torch.core.constants import INT32_MAX
    from procgen_tpu_torch.core.options import GameOptions
    from procgen_tpu_torch.entry import make_env_fns
    from procgen_tpu_torch.games.starpilot import Starpilot
    from procgen_tpu_torch.render import render_kernel as rk

    def game_of(mode, centred):
        game = Starpilot(GameOptions(distribution_mode=mode, center_agent=centred))
        game.level_seed_low, game.level_seed_high = 0, INT32_MAX
        return game

    t0 = time.perf_counter()
    n_trig = libm_check(dev, np, torch)
    log("starpilot", f"libm cosf, sinf, atan2f, and the f64 fish radius and spawner "
        f"products at every distinct rand01 value: card and CPU bit-equal on {n_trig} "
        f"outputs, |x| >= 120 among them, no NaN ({time.perf_counter() - t0:.1f} s)")

    # kernel vs plain version: easy after PRE_STEPS steps under both cameras,
    # hard and extreme after 20, made-up scroll offsets
    init, step, seeds = make_env_fns(NUM_ENVS, "starpilot", device=dev)
    carry = init(seeds)
    rng = np.random.RandomState(1)
    for _ in range(PRE_STEPS):
        acts = torch.as_tensor(rng.randint(0, 15, size=NUM_ENVS), device=dev)
        carry, obs, rew, done = step(carry, acts)
    world = rk.get_plan(game_of(0, False))
    cplan = rk.get_plan(game_of(0, True))
    err = frame_check(rk.prep_frame(world, carry.states),
                      "starpilot-easy states, whole-world camera", rk, torch)
    err = max(err, frame_check(rk.prep_frame(cplan, carry.states),
                               "starpilot-easy states, centred", rk, torch))
    live = int(carry.states.ents.count.sum())
    booms = int(carry.states.decor.count.sum())
    del carry, obs

    live_other = {}
    for mode in (1, 2):
        game = game_of(mode, False)
        s = lifecycle.env_reset(game, lifecycle.initial_state(game, seeds))
        for _ in range(20):
            acts = torch.as_tensor(rng.randint(0, 15, size=NUM_ENVS), device=dev)
            s, _ = lifecycle.env_step(game, s, acts)
        err = max(err, frame_check(rk.prep_frame(rk.get_plan(game), s),
                                   f"starpilot mode {mode} states", rk, torch))
        live_other[mode] = int(s.ents.count.sum())
        del s

    x_syn = rk.synthetic_frame_inputs(
        NUM_ENVS, cplan.NC, 64, cplan.on("grid", dev), cplan.on("bg", dev),
        cplan.atlas(dev), cplan.grid_opaque, seed=7, dcap=32, bg_mode=rk.BG_SCROLL,
    ).to(dev)
    err = max(err, frame_check(x_syn, "made-up scrolled inputs", rk, torch))
    del x_syn
    g = world.game
    err = max(err, edge_frame_check(world, g.ENT_CAP, g.DECOR_CAP, 21, rk, torch))
    log("starpilot", f"render_frame byte-equal: {NUM_ENVS} starpilot-easy states after "
        f"{PRE_STEPS} steps ({live} live slots, {booms} explosions) under the whole-world "
        f"camera (NC {world.NC}) and the centred one (NC {cplan.NC}), {NUM_ENVS} hard "
        f"and {NUM_ENVS} extreme states after 20 steps ({live_other[1]} and "
        f"{live_other[2]} live slots), {NUM_ENVS} made-up scrolled envs, {NUM_ENVS} "
        f"scrolled envs of edge-case slots (caps {g.ENT_CAP} + {g.DECOR_CAP}); "
        f"max_abs_err {err}")

    # the main path
    carry, launches, step, wall_ms = run_slice("starpilot", dev, card, np, torch)
    total = WARM_STEPS + TIMED_STEPS
    if launches["render_frame"] != total or launches["render_suffix"] != 0:
        raise AssertionError(f"starpilot: launches {launches} in {total} steps")

    # the kernel's time against the plain version's: the slice's states
    # under both cameras
    x = rk.prep_frame(world, carry.states)
    kernel_ms, plain_ms, readings = time_frame(x, rk)
    b_ms, b_by, b_work = frame_bound(x, rk, torch)
    xc = rk.prep_frame(cplan, carry.states)
    kc_ms, pc_ms, creadings = time_frame(xc, rk)
    bc_ms, bc_by, bc_work = frame_bound(xc, rk, torch)
    log("starpilot", f"render_frame at N={NUM_ENVS} ({int(carry.states.ents.count.sum())} "
        f"live slots, {int(carry.states.decor.count.sum())} explosions): whole-world "
        f"camera kernel {kernel_ms:.4f} ms, plain torch {plain_ms:.4f} ms (kernel, "
        f"plain, kernel, plain: {readings}), bound {b_ms:.4f} ms ({b_by}; {b_work}); "
        f"centred kernel {kc_ms:.4f} ms, plain {pc_ms:.4f} ms ({creadings}), bound "
        f"{bc_ms:.4f} ms ({bc_by}; {bc_work}) on {card}; <BG_SCROLL> instance: "
        f"{occupancy(rk.frame_occupancy(x))}")
    del x, xc

    gym_centred("starpilot", card, np, torch)
    keys = gpu_matches_cpu("starpilot", np, torch, states=True)
    checked = replay_on_card("starpilot_easy")
    log("starpilot", f"64 envs x 50 steps, centred: GPU and CPU bit-equal (obs, "
        f"rewards, firsts, {', '.join(keys)}); starpilot_easy replay exact "
        f"({checked} steps)")
    return (carry, step, wall_ms), frame_row("starpilot", launches, err, kernel_ms,
                                             plain_ms, b_ms, b_by)


def suffix_check(base, ent_f, ent_i, atlas, nz, decor, what, rk, torch):
    """render_suffix against render_suffix_reference; max abs err."""
    got = rk.render_suffix(base, ent_f, ent_i, atlas, nz, decor)
    want = rk.render_suffix_reference(base, ent_f, ent_i, atlas, nz, decor)
    torch.cuda.synchronize()
    err = int((got.int() - want.int()).abs().max())
    if err != 0:
        raise AssertionError(f"render_suffix != plain on {what} (max err {err})")
    return err


def plunder_phase(dev, card, np, torch):
    from procgen_tpu_torch.core import lifecycle
    from procgen_tpu_torch.entry import make_env_fns
    from procgen_tpu_torch.render import render_kernel as rk

    # kernel vs plain version: easy after PRE_STEPS steps of the slice's program,
    # hard after 30, made-up inputs with a full decor pool
    init, step, seeds = make_env_fns(NUM_ENVS, "plunder", device=dev)
    carry = init(seeds)
    rng = np.random.RandomState(1)
    for _ in range(PRE_STEPS):
        acts = torch.as_tensor(rng.choice([9, 9, 1, 7, 4, 12], size=NUM_ENVS), device=dev)
        carry, obs, rew, done = step(carry, acts)
    plan = rk.get_plan(_game("plunder", 0))
    atlas = plan.atlas(dev)
    nz = len(plan.z_levels)
    s = carry.states
    ent_f, ent_i, decor = rk.prep_suffix(plan, s)
    err = suffix_check(s.frame.contiguous(), ent_f, ent_i, atlas, nz, decor,
                       "plunder-easy states", rk, torch)
    booms = int(s.decor.count.sum())
    live = int(s.ents.count.sum())
    del carry, obs, s

    hard = _game("plunder", 1)
    s = lifecycle.env_reset(hard, lifecycle.initial_state(hard, seeds))
    for _ in range(30):
        acts = torch.as_tensor(rng.choice([9, 9, 1, 7, 4], size=NUM_ENVS), device=dev)
        s, _ = lifecycle.env_step(hard, s, acts)
    hplan = rk.get_plan(hard)
    ent_f, ent_i, decor = rk.prep_suffix(hplan, s)
    err = max(err, suffix_check(s.frame.contiguous(), ent_f, ent_i, hplan.atlas(dev),
                                nz, decor, "plunder-hard states", rk, torch))
    booms_hard = int(s.decor.count.sum())
    del s, ent_f, ent_i, decor

    game = plan.game
    base, ent_f, ent_i, decor = rk.synthetic_suffix_inputs(
        NUM_ENVS, game.ENT_CAP, game.DECOR_CAP, atlas.shape[0], seed=9)
    err = max(err, suffix_check(base.to(dev), ent_f.to(dev), ent_i.to(dev), atlas, nz,
                                decor.to(dev), "made-up inputs, decor pool full", rk,
                                torch))
    base, ent_f, ent_i, decor = rk.synthetic_suffix_inputs(
        NUM_ENVS, game.ENT_CAP, game.DECOR_CAP, atlas.shape[0], seed=23, edges=True)
    err = max(err, suffix_check(base.to(dev), ent_f.to(dev), ent_i.to(dev), atlas, nz,
                                decor.to(dev), "edge-case slots", rk, torch))
    if booms == 0 or booms_hard == 0:
        raise AssertionError(f"plunder: no live explosions ({booms}, {booms_hard})")
    log("plunder", f"render_suffix (decor instance) byte-equal: {NUM_ENVS} plunder-easy "
        f"states after {PRE_STEPS} steps ({live} live slots, {booms} explosions), {NUM_ENVS} "
        f"plunder-hard states after 30 steps ({booms_hard} explosions), {NUM_ENVS} "
        f"made-up envs (cap {game.ENT_CAP}, dcap {game.DECOR_CAP}), {NUM_ENVS} envs of "
        f"edge-case slots at those caps; max_abs_err {err}")
    del base, ent_f, ent_i, decor

    # the main path
    carry, launches, step, wall_ms = run_slice("plunder", dev, card, np, torch)
    total = WARM_STEPS + TIMED_STEPS
    if launches["render_suffix"] != total or launches["render_frame"] != 0:
        raise AssertionError(f"plunder: launches {launches} in {total} steps")

    # the kernel's time against the plain version's, on the slice's states
    s = carry.states
    base = s.frame.contiguous()
    ent_f, ent_i, decor = rk.prep_suffix(plan, s)
    kernel_ms, plain_ms, readings = suffix_times(base, ent_f, ent_i, atlas, nz, decor, rk)
    b_ms, b_by, b_work = suffix_bound(base, ent_f, ent_i, atlas, nz, decor, rk, torch)
    log("plunder", f"render_suffix (decor instance) at N={NUM_ENVS} ({int(s.ents.count.sum())} "
        f"live slots, {int(s.decor.count.sum())} explosions): kernel {kernel_ms:.4f} ms, "
        f"plain torch {plain_ms:.4f} ms (kernel, plain, kernel: {readings}), "
        f"bound {b_ms:.4f} ms ({b_by}; {b_work}) "
        f"on {card}; <true> instance: "
        f"{occupancy(rk.suffix_occupancy(ent_f.shape[1], decor.dec_f.shape[1]))}")
    del base, ent_f, ent_i, decor, s

    keys = gpu_matches_cpu("plunder", np, torch, states=True)
    checked = replay_on_card("plunder_easy")
    log("plunder", f"64 envs x 50 steps: GPU and CPU bit-equal (obs, rewards, firsts, "
        f"{', '.join(keys)}); plunder_easy replay exact ({checked} steps)")
    return (carry, step, wall_ms), {
        "name": "render_suffix",
        "path": "plunder",
        "route": "cuda",
        "source": "procgen_tpu_torch/csrc/render_suffix.cu",
        "replaces": "procgen_tpu/render/pallas_kernel.py:1136",
        "launches": launches["render_suffix"],
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }


def entity_suffix_phase(name, modes, edge_seed, dev, card, np, torch,
                        warm=WARM_STEPS, timed=TIMED_STEPS):
    """A static-prefix game with the entity pool only: the kernel's
    entity-only instance (``render_suffix<false>``, which stages and plans
    all ``cap`` slots) against its plain version on real states of each
    mode and on edge-case slots at the game's cap, the slice, the kernel's
    time and bound, card against CPU, the easy recording.  Returns
    ((carry, step, ms a step), the kernels line's row)."""
    from procgen_tpu_torch.core import lifecycle
    from procgen_tpu_torch.entry import make_env_fns
    from procgen_tpu_torch.render import render_kernel as rk

    plan = rk.get_plan(_game(name, 0))
    atlas = plan.atlas(dev)
    nz = len(plan.z_levels)
    cap = plan.game.ENT_CAP

    # kernel vs plain version: easy after PRE_STEPS steps of the slice's
    # program, the other modes after 20, edge-case slots at the cap
    init, step, seeds = make_env_fns(NUM_ENVS, name, device=dev)
    carry = init(seeds)
    rng = np.random.RandomState(1)
    for _ in range(PRE_STEPS):
        acts = torch.as_tensor(rng.randint(0, 15, size=NUM_ENVS), device=dev)
        carry, obs, rew, done = step(carry, acts)
    s = carry.states
    ent_f, ent_i, extra = rk.prep_suffix(plan, s)
    if extra is not None or ent_f.shape[1] != cap:
        raise AssertionError(f"{name}: not the entity-only instance at cap {cap}")
    err = suffix_check(s.frame.contiguous(), ent_f, ent_i, atlas, nz, None,
                       f"{name}-easy states", rk, torch)
    live = {0: int(s.ents.count.sum())}
    most = int(s.ents.count.max())
    del carry, obs, s, ent_f, ent_i
    for mode in modes[1:]:
        game = _game(name, mode)
        s = lifecycle.env_reset(game, lifecycle.initial_state(game, seeds))
        for _ in range(20):
            acts = torch.as_tensor(rng.randint(0, 15, size=NUM_ENVS), device=dev)
            s, _ = lifecycle.env_step(game, s, acts)
        mplan = rk.get_plan(game)
        ent_f, ent_i, _ = rk.prep_suffix(mplan, s)
        err = max(err, suffix_check(s.frame.contiguous(), ent_f, ent_i, mplan.atlas(dev),
                                    len(mplan.z_levels), None, f"{name} mode {mode} states",
                                    rk, torch))
        live[mode] = int(s.ents.count.sum())
        most = max(most, int(s.ents.count.max()))
        del s, ent_f, ent_i
    ef, ei = rk.synthetic_slots(NUM_ENVS, cap, atlas.shape[0], seed=edge_seed, edges=True)
    sbase = torch.as_tensor(np.random.RandomState(edge_seed).randint(
        0, 256, (NUM_ENVS, 64, 64, 3)).astype(np.uint8), device=dev)
    err = max(err, suffix_check(sbase, ef.to(dev), ei.to(dev), atlas, nz, None,
                                f"edge-case slots, cap {cap}", rk, torch))
    del ef, ei, sbase
    log(name, f"render_suffix (entity-only instance) byte-equal: {NUM_ENVS} states "
        f"of each mode {modes} ({live} live slots, at most {most} in an env), "
        f"{NUM_ENVS} envs of edge-case slots at cap {cap}; max_abs_err {err}")

    # the main path
    carry, launches, step, wall_ms = run_slice(name, dev, card, np, torch, warm, timed)
    total = warm + timed
    if launches["render_suffix"] != total or launches["render_frame"] != 0:
        raise AssertionError(f"{name}: launches {launches} in {total} steps")

    # the kernel's time against the plain version's, on the slice's states
    s = carry.states
    base = s.frame.contiguous()
    ent_f, ent_i, _ = rk.prep_suffix(plan, s)
    kernel_ms, plain_ms, readings = suffix_times(base, ent_f, ent_i, atlas, nz, None, rk)
    b_ms, b_by, b_work = suffix_bound(base, ent_f, ent_i, atlas, nz, None, rk, torch,
                                      count=s.ents.count)
    log(name, f"render_suffix (entity-only instance) at N={NUM_ENVS} "
        f"({int(s.ents.count.sum())} live slots of {NUM_ENVS * cap}): kernel "
        f"{kernel_ms:.4f} ms, plain torch {plain_ms:.4f} ms (kernel, plain, kernel, "
        f"plain: {readings}), bound {b_ms:.4f} ms "
        f"({b_by}; {b_work}), the kernel at {100 * b_ms / kernel_ms:.1f}% of it, on "
        f"{card}; <false> instance at cap {cap}: "
        f"{occupancy(rk.suffix_occupancy(cap, 0))}")
    del base, ent_f, ent_i, s

    keys = gpu_matches_cpu(name, np, torch, states=True)
    checked = replay_on_card(f"{name}_easy")
    log(name, f"64 envs x 50 steps: GPU and CPU bit-equal (obs, rewards, firsts, "
        f"{', '.join(keys)}); {name}_easy replay exact ({checked} steps)")
    return (carry, step, wall_ms), {
        "name": "render_suffix",
        "path": name,
        "route": "cuda",
        "source": "procgen_tpu_torch/csrc/render_suffix.cu",
        "replaces": "procgen_tpu/render/pallas_kernel.py:1136",
        "launches": launches["render_suffix"],
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }


def dodgeball_phase(dev, card, np, torch):
    """Dodgeball: the static-prefix kernel's decor instance at its largest
    caps (72 entity slots, 16 dust clouds), with the lava walls tiled along
    either axis and the rotation banks of the balls, the agent and the
    enemies.  ``render_suffix`` against its plain version on the prep of
    4096 easy states after ``PRE_STEPS`` steps of the slice's program, of
    4096 hard and 4096 extreme states after 30, and on 4096 envs of edge-case slots
    at those caps with made-up walls and bank rows; the slice, the
    kernel's time and bound, card against CPU, the easy recording.
    Returns ((carry, step, ms a step), the kernels line's row)."""
    from procgen_tpu_torch.core import lifecycle
    from procgen_tpu_torch.entry import make_env_fns
    from procgen_tpu_torch.games.dodgeball import LAVA_WALL
    from procgen_tpu_torch.render import render_kernel as rk

    plan = rk.get_plan(_game("dodgeball", 0))
    atlas = plan.atlas(dev)
    nz = len(plan.z_levels)
    cap, dcap = plan.game.ENT_CAP, plan.game.DECOR_CAP

    init, step, seeds = make_env_fns(NUM_ENVS, "dodgeball", device=dev)
    carry = init(seeds)
    rng = np.random.RandomState(1)
    for _ in range(PRE_STEPS):
        acts = torch.as_tensor(rng.choice([9, 9, 1, 3, 5, 7, 4], size=NUM_ENVS), device=dev)
        carry, obs, rew, done = step(carry, acts)
    s = carry.states
    ent_f, ent_i, decor = rk.prep_suffix(plan, s)
    if ent_f.shape[1] != cap or decor is None or decor.dec_f.shape[1] != dcap:
        raise AssertionError(f"dodgeball: not the decor instance at caps {cap} + {dcap}")
    err = suffix_check(s.frame.contiguous(), ent_f, ent_i, atlas, nz, decor,
                       "dodgeball-easy states", rk, torch)
    live = {0: int(s.ents.count.sum())}
    clouds = {0: int(s.decor.count.sum())}
    row = ent_i[..., rk.EI_ROW]
    banked = {0: int(((row > plan.ent_atlas.transparent_row) & (row < plan.n1e)
                      & (ent_i[..., rk.EI_LIVE] > 0)).sum())}
    vertical = {0: int((ent_i[..., rk.EI_TILEV] > 0).sum())}
    del carry, obs, s, ent_f, ent_i, decor
    for mode in (1, 2):
        game = _game("dodgeball", mode)
        s = lifecycle.env_reset(game, lifecycle.initial_state(game, seeds))
        for _ in range(30):
            acts = torch.as_tensor(rng.choice([9, 9, 1, 3, 5, 7, 4], size=NUM_ENVS),
                                   device=dev)
            s, _ = lifecycle.env_step(game, s, acts)
        mplan = rk.get_plan(game)
        ent_f, ent_i, decor = rk.prep_suffix(mplan, s)
        err = max(err, suffix_check(s.frame.contiguous(), ent_f, ent_i, mplan.atlas(dev),
                                    nz, decor, f"dodgeball mode {mode} states", rk, torch))
        live[mode], clouds[mode] = int(s.ents.count.sum()), int(s.decor.count.sum())
        vertical[mode] = int((ent_i[..., rk.EI_TILEV] > 0).sum())
        del s, ent_f, ent_i, decor

    wall = int(plan.ent_atlas.row_for(torch.tensor([LAVA_WALL]), torch.tensor([0]))[0])
    base, ent_f, ent_i, decor = rk.synthetic_wall_inputs(NUM_ENVS, plan, wall, seed=29)
    err = max(err, suffix_check(base.to(dev), ent_f.to(dev), ent_i.to(dev), atlas, nz,
                                decor.to(dev), "edge-case slots with walls and banks", rk,
                                torch))
    del base, ent_f, ent_i, decor
    if min(vertical.values()) == 0 or banked[0] == 0:
        raise AssertionError(f"dodgeball: no vertical walls ({vertical}) or no banked "
                             f"sprites ({banked})")
    log("dodgeball", f"render_suffix (decor instance) byte-equal: {NUM_ENVS} states of "
        f"each mode (0, 1, 2) ({live} live slots, {clouds} dust clouds, {vertical} "
        f"walls tiled along y, {banked} banked sprites in easy), {NUM_ENVS} envs of "
        f"edge-case slots at caps {cap} + {dcap} with made-up walls tiled along x and "
        f"y and bank rows; max_abs_err {err}")

    # the main path
    carry, launches, step, wall_ms = run_slice("dodgeball", dev, card, np, torch)
    total = WARM_STEPS + TIMED_STEPS
    if launches["render_suffix"] != total or launches["render_frame"] != 0:
        raise AssertionError(f"dodgeball: launches {launches} in {total} steps")

    # the kernel's time against the plain version's, on the slice's states
    s = carry.states
    base = s.frame.contiguous()
    ent_f, ent_i, decor = rk.prep_suffix(plan, s)
    kernel_ms, plain_ms, readings = suffix_times(base, ent_f, ent_i, atlas, nz, decor, rk)
    b_ms, b_by, b_work = suffix_bound(base, ent_f, ent_i, atlas, nz, decor, rk, torch)
    log("dodgeball", f"render_suffix (decor instance) at N={NUM_ENVS} "
        f"({int(s.ents.count.sum())} live slots, {int(s.decor.count.sum())} dust clouds): "
        f"kernel {kernel_ms:.4f} ms, plain torch {plain_ms:.4f} ms (kernel, plain, kernel, "
        f"plain: {readings}), bound {b_ms:.4f} ms ({b_by}; "
        f"{b_work}), the kernel at {100 * b_ms / kernel_ms:.1f}% of it, on {card}; "
        f"<true> instance at caps {cap} + {dcap}: {occupancy(rk.suffix_occupancy(cap, dcap))}")
    del base, ent_f, ent_i, decor, s

    keys = gpu_matches_cpu("dodgeball", np, torch, states=True)
    checked = replay_on_card("dodgeball_easy")
    log("dodgeball", f"64 envs x 50 steps: GPU and CPU bit-equal (obs, rewards, firsts, "
        f"{', '.join(keys)}); dodgeball_easy replay exact ({checked} steps)")
    return (carry, step, wall_ms), {
        "name": "render_suffix",
        "path": "dodgeball",
        "route": "cuda",
        "source": "procgen_tpu_torch/csrc/render_suffix.cu",
        "replaces": "procgen_tpu/render/pallas_kernel.py:1136",
        "launches": launches["render_suffix"],
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }


def bossfight_phase(dev, card, np, torch):
    """Bossfight: the static-prefix kernel's decor instance at the largest
    pools a game has (72 entity slots, 160 laser trails and explosions:
    69,104 B of dynamic shared memory a block), the enemy bullets and
    their trails on the rotation banks.  The slice first; then
    ``render_suffix`` against its plain version on the prep of its 4096
    easy states, of 4096 hard states after 30 steps, and on 4096 envs of
    edge-case slots at those caps with made-up tiled slots and bank rows;
    the instance's occupancy, the kernel's time and bound on the slice's
    states, card against CPU, the easy recording.  Returns ((carry, step,
    ms a step), the kernels line's row)."""
    from procgen_tpu_torch.core import lifecycle
    from procgen_tpu_torch.games.bossfight import BARRIER
    from procgen_tpu_torch.render import render_kernel as rk

    plan = rk.get_plan(_game("bossfight", 0))
    atlas = plan.atlas(dev)
    nz = len(plan.z_levels)
    cap, dcap = plan.game.ENT_CAP, plan.game.DECOR_CAP
    occ = rk.suffix_occupancy(cap, dcap)
    if occ["smem_bytes"] != rk.suffix_smem(cap, dcap) or occ["blocks_per_sm"] < 1:
        raise AssertionError(f"bossfight: the <true> instance at caps {cap} + {dcap}: {occ}")

    # the main path
    carry, launches, step, wall_ms = run_slice("bossfight", dev, card, np, torch)
    total = WARM_STEPS + TIMED_STEPS
    if launches["render_suffix"] != total or launches["render_frame"] != 0:
        raise AssertionError(f"bossfight: launches {launches} in {total} steps")

    # kernel vs plain version: the slice's easy states, hard states after
    # 30 steps, edge-case slots at the caps
    def banked(ent_i):
        row = ent_i[..., rk.EI_ROW]
        return int(((row > plan.ent_atlas.transparent_row) & (row < plan.n1e)
                    & (ent_i[..., rk.EI_LIVE] > 0)).sum())

    s = carry.states
    ent_f, ent_i, decor = rk.prep_suffix(plan, s)
    if ent_f.shape[1] != cap or decor is None or decor.dec_f.shape[1] != dcap:
        raise AssertionError(f"bossfight: not the decor instance at caps {cap} + {dcap}")
    err = suffix_check(s.frame.contiguous(), ent_f, ent_i, atlas, nz, decor,
                       "bossfight-easy states", rk, torch)
    live = {0: int(s.ents.count.sum())}
    trails = {0: int(s.decor.count.sum())}
    most = {0: int(s.decor.count.max())}
    banks = {0: banked(ent_i) + banked(decor.dec_i)}
    del ent_f, ent_i, decor
    game = _game("bossfight", 1)
    seeds = torch.as_tensor(np.random.RandomState(47).randint(0, 2**31, NUM_ENVS),
                            dtype=torch.int64, device=dev)
    hs = lifecycle.env_reset(game, lifecycle.initial_state(game, seeds))
    rng = np.random.RandomState(1)
    for _ in range(30):
        acts = torch.as_tensor(rng.choice([9, 9, 1, 3, 5, 7, 4], size=NUM_ENVS), device=dev)
        hs, _ = lifecycle.env_step(game, hs, acts)
    hplan = rk.get_plan(game)
    ent_f, ent_i, decor = rk.prep_suffix(hplan, hs)
    err = max(err, suffix_check(hs.frame.contiguous(), ent_f, ent_i, hplan.atlas(dev), nz,
                                decor, "bossfight-hard states", rk, torch))
    live[1], trails[1] = int(hs.ents.count.sum()), int(hs.decor.count.sum())
    most[1], banks[1] = int(hs.decor.count.max()), banked(ent_i) + banked(decor.dec_i)
    del hs, ent_f, ent_i, decor

    meteor = int(plan.ent_atlas.row_for(torch.tensor([BARRIER]), torch.tensor([0]))[0])
    base, ent_f, ent_i, decor = rk.synthetic_wall_inputs(NUM_ENVS, plan, meteor, seed=47)
    err = max(err, suffix_check(base.to(dev), ent_f.to(dev), ent_i.to(dev), atlas, nz,
                                decor.to(dev), "edge-case slots at caps 72 + 160", rk, torch))
    del base, ent_f, ent_i, decor
    if min(banks.values()) == 0 or min(most.values()) < 8:
        raise AssertionError(f"bossfight: no banked sprites ({banks}) or few trails ({most})")
    log("bossfight", f"render_suffix (decor instance) byte-equal: {NUM_ENVS} states of "
        f"each mode (0: the slice's, 1: after 30 steps) ({live} live slots, {trails} "
        f"trails and explosions, at most {most} in an env, {banks} banked sprites), "
        f"{NUM_ENVS} envs of edge-case slots at caps {cap} + {dcap} with made-up tiled "
        f"slots and bank rows; max_abs_err {err}; <true> instance at caps {cap} + "
        f"{dcap}: {occupancy(occ)}")

    # the kernel's time against the plain version's, on the slice's states
    base = s.frame.contiguous()
    ent_f, ent_i, decor = rk.prep_suffix(plan, s)
    kernel_ms, plain_ms, readings = suffix_times(base, ent_f, ent_i, atlas, nz, decor, rk)
    b_ms, b_by, b_work = suffix_bound(base, ent_f, ent_i, atlas, nz, decor, rk, torch)
    log("bossfight", f"render_suffix (decor instance) at N={NUM_ENVS} "
        f"({int(s.ents.count.sum())} live slots, {int(s.decor.count.sum())} trails and "
        f"explosions): kernel {kernel_ms:.4f} ms, plain torch {plain_ms:.4f} ms (kernel, "
        f"plain, kernel, plain: {readings}), bound {b_ms:.4f} ms ({b_by}; {b_work}), the "
        f"kernel at {100 * b_ms / kernel_ms:.1f}% of it, on {card}")
    del base, ent_f, ent_i, decor, s

    keys = gpu_matches_cpu("bossfight", np, torch, states=True)
    checked = replay_on_card("bossfight_easy")
    log("bossfight", f"64 envs x 50 steps: GPU and CPU bit-equal (obs, rewards, firsts, "
        f"{', '.join(keys)}); bossfight_easy replay exact ({checked} steps)")
    return (carry, step, wall_ms), {
        "name": "render_suffix",
        "path": "bossfight",
        "route": "cuda",
        "source": "procgen_tpu_torch/csrc/render_suffix.cu",
        "replaces": "procgen_tpu/render/pallas_kernel.py:1136",
        "launches": launches["render_suffix"],
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }


def climber_phase(dev, card, np, torch):
    """Climber: the whole-frame kernel under the game's own camera.  The
    slice first; then ``render_frame`` against its plain version on the
    prep of its 4096 easy states and of 4096 hard states after 20 steps,
    each under the whole-world camera (a 64-cell window) and the centred
    one (the world's width in view, a 19-cell window), and on 4096 envs of
    edge-case slots in the centred window; the kernel's time and bound
    under both cameras on the slice's states, the centred
    ``ProcgenGym3Env``, card against CPU, the easy recording.  Returns
    ((carry, step, ms a step), the kernels line's row)."""
    from procgen_tpu_torch.core import lifecycle
    from procgen_tpu_torch.core.constants import INT32_MAX
    from procgen_tpu_torch.core.options import GameOptions
    from procgen_tpu_torch.games.climber import Climber
    from procgen_tpu_torch.render import render_kernel as rk

    def game_of(mode, centred):
        game = Climber(GameOptions(distribution_mode=mode, center_agent=centred))
        game.level_seed_low, game.level_seed_high = 0, INT32_MAX
        return game

    # the main path
    carry, launches, step, wall_ms = run_slice("climber", dev, card, np, torch)
    total = WARM_STEPS + TIMED_STEPS
    if launches["render_frame"] != total or launches["render_suffix"] != 0:
        raise AssertionError(f"climber: launches {launches} in {total} steps")

    # kernel vs plain version under both cameras: the slice's easy states,
    # hard states after 20 steps, edge-case slots in the centred window
    hard = game_of(1, False)
    seeds = torch.as_tensor(np.random.RandomState(53).randint(0, 2**31, NUM_ENVS),
                            dtype=torch.int64, device=dev)
    hs = lifecycle.env_reset(hard, lifecycle.initial_state(hard, seeds))
    rng = np.random.RandomState(1)
    for _ in range(20):
        acts = torch.as_tensor(rng.choice([2, 5, 8, 8, 6, 0, 4], size=NUM_ENVS), device=dev)
        hs, _ = lifecycle.env_step(hard, hs, acts)
    err, windows, xs = 0, {}, {}
    for mode, st in ((0, carry.states), (1, hs)):
        for centred in (False, True):
            plan = rk.get_plan(game_of(mode, centred))
            x = rk.prep_frame(plan, st)
            windows[(mode, centred)] = (x.gtab.shape[1], float(x.sf[0, rk.SF_VIS]))
            err = max(err, frame_check(x, f"climber mode {mode} states, "
                                          f"{'centred' if centred else 'whole world'}",
                                       rk, torch))
            if mode == 0:
                xs[centred] = x
    live = {0: int(carry.states.ents.count.sum()), 1: int(hs.ents.count.sum())}
    del hs, x
    if windows[(0, False)][0] != 64 or windows[(0, True)] != (19, 16.0) \
            or windows[(1, True)] != (19, 20.0):
        raise AssertionError(f"climber: windows (NC, view) {windows}")
    cplan = rk.get_plan(game_of(0, True))
    err = max(err, edge_frame_check(cplan, cplan.game.ENT_CAP, 0, 53, rk, torch))
    log("climber", f"render_frame byte-equal: {NUM_ENVS} states of each mode (0: the "
        f"slice's, 1: after 20 steps) ({live} live slots) under the whole-world camera and "
        f"the game's centred one (window NC and view cells by (mode, centred): "
        f"{windows}), {NUM_ENVS} envs of edge-case slots in the centred window (cap "
        f"{cplan.game.ENT_CAP}); max_abs_err {err}")

    # the kernel's time against the plain version's, on the slice's states
    # under both cameras
    x, xc = xs[False], xs[True]
    kernel_ms, plain_ms, readings = time_frame(x, rk)
    b_ms, b_by, b_work = frame_bound(x, rk, torch)
    kc_ms, pc_ms, creadings = time_frame(xc, rk)
    bc_ms, bc_by, bc_work = frame_bound(xc, rk, torch)
    log("climber", f"render_frame at N={NUM_ENVS} ({live[0]} live slots): whole-world "
        f"camera (NC 64) kernel {kernel_ms:.4f} ms, plain torch {plain_ms:.4f} ms (kernel, "
        f"plain, kernel, plain: {readings}), bound {b_ms:.4f} ms ({b_by}; {b_work}); "
        f"centred (NC 19) kernel {kc_ms:.4f} ms, plain {pc_ms:.4f} ms ({creadings}), bound "
        f"{bc_ms:.4f} ms ({bc_by}; {bc_work}) on {card}; <BG_CROP> instance, whole world: "
        f"{occupancy(rk.frame_occupancy(x))}; centred: {occupancy(rk.frame_occupancy(xc))}")
    del x, xc, xs

    gym_centred("climber", card, np, torch)
    keys = gpu_matches_cpu("climber", np, torch, states=True)
    checked = replay_on_card("climber_easy")
    log("climber", f"64 envs x 50 steps, centred: GPU and CPU bit-equal (obs, rewards, "
        f"firsts, {', '.join(keys)}); climber_easy replay exact ({checked} steps)")
    return (carry, step, wall_ms), frame_row("climber", launches, err, kernel_ms,
                                             plain_ms, b_ms, b_by)

def ninja_phase(dev, card, np, torch):
    """Ninja: the whole-frame kernel over the 64x64 world and under the
    agent-centred camera, the throwing stars' grid dispatch on the main
    path.  The slice first; then ``render_frame`` against its plain version
    on the prep of the slice's 4096 easy states and of 4096 hard states
    after 20 steps of jumps and throws, each under the whole-world camera
    (a 64-cell window) and the centred one (``visibility + 3`` cells: 13
    easy, 19 hard), and on 4096 envs of edge-case slots in the centred
    window; the kernel's time and bound under both cameras on the slice's
    states, the instances' occupancy, the centred ``ProcgenGym3Env``, card
    against CPU, the easy recording.  Returns ((carry, step, ms a step),
    the kernels line's row)."""
    from procgen_tpu_torch.core import lifecycle
    from procgen_tpu_torch.core.constants import INT32_MAX
    from procgen_tpu_torch.core.options import GameOptions
    from procgen_tpu_torch.games.ninja import THROWING_STAR, Ninja
    from procgen_tpu_torch.render import render_kernel as rk

    def game_of(mode, centred):
        game = Ninja(GameOptions(distribution_mode=mode, center_agent=centred))
        game.level_seed_low, game.level_seed_high = 0, INT32_MAX
        return game

    # the main path
    carry, launches, step, wall_ms = run_slice("ninja", dev, card, np, torch)
    total = WARM_STEPS + TIMED_STEPS
    if launches["render_frame"] != total or launches["render_suffix"] != 0:
        raise AssertionError(f"ninja: launches {launches} in {total} steps")

    # kernel vs plain version under both cameras: the slice's easy states,
    # hard states after 20 steps, edge-case slots in the centred window
    hard = game_of(1, False)
    seeds = torch.as_tensor(np.random.RandomState(59).randint(0, 2**31, NUM_ENVS),
                            dtype=torch.int64, device=dev)
    hs = lifecycle.env_reset(hard, lifecycle.initial_state(hard, seeds))
    rng = np.random.RandomState(1)
    for _ in range(20):
        acts = torch.as_tensor(rng.choice([2, 5, 8, 9, 10, 11, 12, 4], size=NUM_ENVS),
                               device=dev)
        hs, _ = lifecycle.env_step(hard, hs, acts)
    err, windows, xs = 0, {}, {}
    for mode, st in ((0, carry.states), (1, hs)):
        for centred in (False, True):
            plan = rk.get_plan(game_of(mode, centred))
            x = rk.prep_frame(plan, st)
            windows[(mode, centred)] = (x.gtab.shape[1], float(x.sf[0, rk.SF_VIS]))
            err = max(err, frame_check(x, f"ninja mode {mode} states, "
                                          f"{'centred' if centred else 'whole world'}",
                                       rk, torch))
            if mode == 0:
                xs[centred] = x
    stars = {m: int((st.ents.active & (st.ents.type == THROWING_STAR)).sum())
             for m, st in ((0, carry.states), (1, hs))}
    live = {0: int(carry.states.ents.count.sum()), 1: int(hs.ents.count.sum())}
    del hs, x
    if windows[(0, False)][0] != 64 or windows[(0, True)] != (13, 10.0) \
            or windows[(1, True)] != (19, 16.0):
        raise AssertionError(f"ninja: windows (NC, view) {windows}")
    cplan = rk.get_plan(game_of(0, True))
    err = max(err, edge_frame_check(cplan, cplan.game.ENT_CAP, 0, 59, rk, torch))
    log("ninja", f"render_frame byte-equal: {NUM_ENVS} states of each mode (0: the "
        f"slice's, 1: after 20 steps) ({live} live slots, {stars} throwing stars) under "
        f"the whole-world camera and the centred one (window NC and view cells by "
        f"(mode, centred): {windows}), {NUM_ENVS} envs of edge-case slots in the centred "
        f"window (cap {cplan.game.ENT_CAP}); max_abs_err {err}")

    # the kernel's time against the plain version's, on the slice's states
    # under both cameras
    x, xc = xs[False], xs[True]
    kernel_ms, plain_ms, readings = time_frame(x, rk)
    b_ms, b_by, b_work = frame_bound(x, rk, torch)
    kc_ms, pc_ms, creadings = time_frame(xc, rk)
    bc_ms, bc_by, bc_work = frame_bound(xc, rk, torch)
    log("ninja", f"render_frame at N={NUM_ENVS} ({live[0]} live slots): whole-world "
        f"camera (NC 64) kernel {kernel_ms:.4f} ms, plain torch {plain_ms:.4f} ms (kernel, "
        f"plain, kernel, plain: {readings}), bound {b_ms:.4f} ms ({b_by}; {b_work}), the "
        f"kernel at {100 * b_ms / kernel_ms:.1f}% of it; centred (NC 13) kernel {kc_ms:.4f} "
        f"ms, plain {pc_ms:.4f} ms ({creadings}), bound {bc_ms:.4f} ms ({bc_by}; "
        f"{bc_work}), {100 * bc_ms / kc_ms:.1f}%, on {card}; <BG_CROP> instance, whole "
        f"world: {occupancy(rk.frame_occupancy(x))}; centred: "
        f"{occupancy(rk.frame_occupancy(xc))}")
    del x, xc, xs

    gym_centred("ninja", card, np, torch)
    keys = gpu_matches_cpu("ninja", np, torch, states=True)
    checked = replay_on_card("ninja_easy")
    log("ninja", f"64 envs x {CPU_STEPS} steps: GPU and CPU bit-equal (obs, rewards, "
        f"firsts, {', '.join(keys)}); ninja_easy replay exact ({checked} steps)")
    return (carry, step, wall_ms), frame_row("ninja", launches, err, kernel_ms,
                                             plain_ms, b_ms, b_by)


def chaser_phase(dev, card, np, torch):
    """Chaser: the whole-frame kernel under the static camera over the maze
    (11, 13 and 19 cells), its orbs the first colored cells drawn at a
    fractional inset (0.3 of a cell).  The slice first; then
    ``render_frame`` against its plain version on the prep of the slice's
    4096 easy states and of 4096 hard and 4096 extreme states after 20
    steps, on 4096 envs of each window whose pixels fall a few ulps from
    the orbs' edges (``synthetic_orb_inputs``), and on 4096 envs of
    edge-case slots; the kernel's time and bound in each window and the
    instances' occupancy; card against CPU; the easy recording.  The game
    forces the static camera, so it has no centred gym3 run.  Returns
    ((carry, step, ms a step), the kernels line's row)."""
    from procgen_tpu_torch.core import lifecycle
    from procgen_tpu_torch.games.chaser import ORB
    from procgen_tpu_torch.render import render_kernel as rk

    # the main path
    carry, launches, step, wall_ms = run_slice("chaser", dev, card, np, torch)
    total = WARM_STEPS + TIMED_STEPS
    if launches["render_frame"] != total or launches["render_suffix"] != 0:
        raise AssertionError(f"chaser: launches {launches} in {total} steps")

    # kernel vs plain version in each mode's window: the slice's easy
    # states, hard and extreme states after 20 steps
    seeds = torch.as_tensor(np.random.RandomState(61).randint(0, 2**31, NUM_ENVS),
                            dtype=torch.int64, device=dev)
    rng = np.random.RandomState(1)
    err, timed, occ, orbs, edges = 0, {}, {}, {}, {}
    for mode in (0, 1, 2):
        game = _game("chaser", mode)
        plan = rk.get_plan(game)
        if mode == 0:
            st = carry.states
        else:
            st = lifecycle.env_reset(game, lifecycle.initial_state(game, seeds))
            for _ in range(20):
                acts = torch.as_tensor(rng.randint(0, 15, size=NUM_ENVS), device=dev)
                st, _ = lifecycle.env_step(game, st, acts)
        x = rk.prep_frame(plan, st)
        if plan.static or x.gtab.shape[1] != game.maze_dim \
                or float(x.sf[0, rk.SF_VIS]) != game.maze_dim:
            raise AssertionError(f"chaser mode {mode}: window of {x.gtab.shape[1]} cells")
        orbs[mode] = int((st.grid == ORB).sum())
        err = max(err, frame_check(x, f"chaser mode {mode} states (NC {plan.NC})", rk, torch))
        timed[mode] = (plan.NC, *time_frame(x, rk), *frame_bound(x, rk, torch))
        occ[mode] = occupancy(rk.frame_occupancy(x))
        # pixels a few ulps from the orbs' edges in this window
        xo = rk.synthetic_orb_inputs(NUM_ENVS, plan.NC, plan.on("grid", dev),
                                     plan.on("bg", dev), plan.atlas(dev), plan.grid_opaque,
                                     seed=61 + mode).to(dev)
        edges[mode] = int(rk.orb_edge_pixels(xo).sum())
        err = max(err, frame_check(xo, f"orb-edge pixels, NC {plan.NC}", rk, torch))
        if mode > 0:
            del st
        del x, xo
    plan0 = rk.get_plan(_game("chaser", 0))
    err = max(err, edge_frame_check(plan0, plan0.game.ENT_CAP, 0, 61, rk, torch))
    log("chaser", f"render_frame byte-equal: {NUM_ENVS} states of each mode (0: the "
        f"slice's, 1 and 2: after 20 steps; small orbs on the grid by mode: {orbs}), "
        f"{NUM_ENVS} envs of orb-edge pixels in each window (pixels within 8 ulps of the "
        f"0.3 inset's edges by mode: {edges}), {NUM_ENVS} envs of edge-case slots (cap "
        f"{plan0.game.ENT_CAP}); max_abs_err {err}")
    for mode, (NC, k_ms, p_ms, readings, b_ms, b_by, work) in timed.items():
        log("chaser", f"render_frame (mode {mode}, NC {NC}) at N={NUM_ENVS}: kernel "
            f"{k_ms:.4f} ms, plain torch {p_ms:.4f} ms (kernel, plain, kernel: "
            f"{readings}), bound {b_ms:.4f} ms ({b_by}; {work}), the kernel at "
            f"{100 * b_ms / k_ms:.1f}% of it, on {card}; <BG_CROP> instance: {occ[mode]}")

    keys = gpu_matches_cpu("chaser", np, torch, states=True)
    checked = replay_on_card("chaser_easy")
    log("chaser", f"64 envs x {CPU_STEPS} steps: GPU and CPU bit-equal (obs, rewards, "
        f"firsts, {', '.join(keys)}); chaser_easy replay exact ({checked} steps)")
    _, kernel_ms, plain_ms, _, b_ms, b_by, _ = timed[0]
    return (carry, step, wall_ms), frame_row("chaser", launches, err, kernel_ms,
                                             plain_ms, b_ms, b_by)


def heist_phase(dev, card, np, torch):
    """Heist: the whole-frame kernel under the static camera (9 and 13
    cells) and memory mode's centred one (11 cells), the key ring's keys
    the first slots in screen coordinates (render_z 1), the agent on the
    rotation banks.  The slice first; then ``render_frame`` against its
    plain version on the prep of the slice's 4096 easy states and of 4096
    hard and 4096 memory states after 20 steps, each as they are and with
    every key held (the ring showing) and the agent turned to its 8
    facings, and on 4096 envs of edge-case slots in the centred window;
    the kernel's time and bound in each window and the instances'
    occupancy; memory mode's centred ``ProcgenGym3Env``; card against CPU;
    the easy recording.  Returns ((carry, step, ms a step), the kernels
    line's row)."""
    from procgen_tpu_torch.core import lifecycle
    from procgen_tpu_torch.core import rng as trng
    from procgen_tpu_torch.core.constants import MEMORY_MODE
    from procgen_tpu_torch.games.heist import KEY_ON_RING, with_ring_and_facings
    from procgen_tpu_torch.levelgen import maze as mazegen
    from procgen_tpu_torch.render import render_kernel as rk

    # the main path
    carry, launches, step, wall_ms = run_slice("heist", dev, card, np, torch)
    total = WARM_STEPS + TIMED_STEPS
    if launches["render_frame"] != total or launches["render_suffix"] != 0:
        raise AssertionError(f"heist: launches {launches} in {total} steps")

    # the maze with doors of a 64-env easy reset: its BFS rounds (each a
    # host read) and torch operations
    rs = np.random.RandomState(67)
    stats = {}
    g = trng.seed(torch.as_tensor(rs.randint(0, 2**31, RESET_CHUNK), device=dev))
    ops = torch_ops(lambda: mazegen.generate_maze_with_doors(
        g, torch.as_tensor(rs.randint(0, 3, RESET_CHUNK) * 2 + 5, dtype=torch.int32,
                           device=dev), 9,
        torch.as_tensor(rs.randint(0, 4, RESET_CHUNK), dtype=torch.int32, device=dev), stats))
    log("heist", f"maze with doors of {RESET_CHUNK} easy envs: {stats['rounds']} BFS rounds, "
        f"{ops} torch operations")

    # kernel vs plain version in each mode's window: the slice's easy
    # states, hard and memory states after 20 steps; each again with every
    # key held and the agent in facing (env mod 8)
    seeds = torch.as_tensor(np.random.RandomState(67).randint(0, 2**31, NUM_ENVS),
                            dtype=torch.int64, device=dev)
    rng = np.random.RandomState(1)
    err, timed, occ, rings = 0, {}, {}, {}
    for mode in (0, 1, MEMORY_MODE):
        game = _game("heist", mode)
        plan = rk.get_plan(game)
        if mode == 0:
            st = carry.states
        else:
            st = lifecycle.env_reset(game, lifecycle.initial_state(game, seeds))
            for _ in range(20):
                acts = torch.as_tensor(rng.randint(0, 15, size=NUM_ENVS), device=dev)
                st, _ = lifecycle.env_step(game, st, acts)
        held = with_ring_and_facings(st)
        rings[mode] = int((held.ents.active & (held.ents.type == KEY_ON_RING)).sum())
        want_nc = 11 if mode == MEMORY_MODE else game.world_dim
        for what, s_ in (("states", st), ("states, every key held, 8 facings", held)):
            x = rk.prep_frame(plan, s_)
            if plan.static or x.gtab.shape[1] != want_nc:
                raise AssertionError(f"heist mode {mode}: window of {x.gtab.shape[1]} cells")
            err = max(err, frame_check(x, f"heist mode {mode} {what} (NC {want_nc})", rk,
                                       torch))
        x = rk.prep_frame(plan, st)
        timed[mode] = (want_nc, *time_frame(x, rk), *frame_bound(x, rk, torch))
        occ[mode] = occupancy(rk.frame_occupancy(x))
        if mode > 0:
            del st
        del x, held
    mplan = rk.get_plan(_game("heist", MEMORY_MODE))
    err = max(err, edge_frame_check(mplan, mplan.game.ENT_CAP, 0, 67, rk, torch))
    log("heist", f"render_frame byte-equal: {NUM_ENVS} states of each mode (0: the "
        f"slice's, 1 and 10: after 20 steps), each also with every key held and the agent "
        f"in its 8 facings (ring keys shown by mode: {rings}), {NUM_ENVS} envs of "
        f"edge-case slots in the centred 11-cell window (cap {mplan.game.ENT_CAP}); "
        f"max_abs_err {err}")
    for mode, (NC, k_ms, p_ms, readings, b_ms, b_by, work) in timed.items():
        log("heist", f"render_frame (mode {mode}, NC {NC}) at N={NUM_ENVS}: kernel "
            f"{k_ms:.4f} ms, plain torch {p_ms:.4f} ms (kernel, plain, kernel: "
            f"{readings}), bound {b_ms:.4f} ms ({b_by}; {work}), the kernel at "
            f"{100 * b_ms / k_ms:.1f}% of it, on {card}; <BG_CROP> instance: {occ[mode]}")

    gym_centred("heist", card, np, torch, mode="memory")
    keys = gpu_matches_cpu("heist", np, torch, states=True)
    checked = replay_on_card("heist_easy")
    log("heist", f"64 envs x {CPU_STEPS} steps: GPU and CPU bit-equal (obs, rewards, "
        f"firsts, {', '.join(keys)}); heist_easy replay exact ({checked} steps)")
    _, kernel_ms, plain_ms, _, b_ms, b_by, _ = timed[0]
    return (carry, step, wall_ms), frame_row("heist", launches, err, kernel_ms,
                                             plain_ms, b_ms, b_by)


def jumper_phase(dev, card, np, torch):
    """Jumper: the whole-frame kernel over the whole world (20, 40 and 45
    cells) and under the agent-centred camera (15 and 19 cells), 64 entity
    slots beside the 16 trails of the decor pool (alpha 0.5), the compass
    and distance bar drawn after the kernel (``renderer.post``).  The
    slice first; then ``render_frame`` against its plain version on the
    prep of the slice's 4096 easy states and of 4096 hard and 4096 memory
    states after 20 steps, each under both cameras, and on 4096 envs of
    edge-case slots with both pools full in the centred and whole-world
    easy windows; the kernel's time and bound in each window and the
    instances' occupancy; the centred ``ProcgenGym3Env``; card against
    CPU; the easy recording.  Returns ((carry, step, ms a step), the
    kernels line's row)."""
    from procgen_tpu_torch.core import lifecycle
    from procgen_tpu_torch.core.constants import INT32_MAX, MEMORY_MODE
    from procgen_tpu_torch.core.options import GameOptions
    from procgen_tpu_torch.games.jumper import Jumper
    from procgen_tpu_torch.render import render_kernel as rk

    def game_of(mode, centred):
        game = Jumper(GameOptions(distribution_mode=mode, center_agent=centred))
        game.level_seed_low, game.level_seed_high = 0, INT32_MAX
        return game

    # the main path
    carry, launches, step, wall_ms = run_slice("jumper", dev, card, np, torch)
    total = WARM_STEPS + TIMED_STEPS
    if launches["render_frame"] != total or launches["render_suffix"] != 0:
        raise AssertionError(f"jumper: launches {launches} in {total} steps")

    # kernel vs plain version under both cameras: the slice's easy states,
    # hard and memory states after 20 steps
    seeds = torch.as_tensor(np.random.RandomState(71).randint(0, 2**31, NUM_ENVS),
                            dtype=torch.int64, device=dev)
    rng = np.random.RandomState(1)
    err, timed, occ, trails = 0, {}, {}, {}
    for mode in (0, 1, MEMORY_MODE):
        if mode == 0:
            st = carry.states
        else:
            game = game_of(mode, False)
            st = lifecycle.env_reset(game, lifecycle.initial_state(game, seeds))
            for _ in range(20):
                acts = torch.as_tensor(rng.choice([2, 5, 8, 8, 6, 0, 3], size=NUM_ENVS),
                                       device=dev)
                st, _ = lifecycle.env_step(game, st, acts)
        trails[mode] = int(st.decor.count.sum())
        for centred in (False, True):
            game = game_of(mode, centred)
            plan = rk.get_plan(game)
            want_nc = int(game.visibility) + 3 if centred else game.world_dim
            x = rk.prep_frame(plan, st)
            if plan.static or x.gtab.shape[1] != want_nc:
                raise AssertionError(f"jumper mode {mode}: window of {x.gtab.shape[1]} cells")
            err = max(err, frame_check(x, f"jumper mode {mode} states (NC {want_nc})", rk,
                                       torch))
            timed[(mode, want_nc)] = (*time_frame(x, rk), *frame_bound(x, rk, torch))
            occ[(mode, want_nc)] = occupancy(rk.frame_occupancy(x))
            del x
        if mode > 0:
            del st
    for centred in (False, True):
        plan = rk.get_plan(game_of(0, centred))
        err = max(err, edge_frame_check(plan, plan.game.ENT_CAP, plan.game.DECOR_CAP,
                                        71 + centred, rk, torch))
    log("jumper", f"render_frame byte-equal: {NUM_ENVS} states of each mode (0: the "
        f"slice's, 1 and 10: after 20 steps; live trails by mode: {trails}) under the "
        f"whole-world camera and the centred one (windows by (mode, NC): {list(timed)}), "
        f"{NUM_ENVS} envs of edge-case slots with both pools full (caps 64 + 16) in the "
        f"easy windows (20 and 15 cells); max_abs_err {err}")
    for (mode, NC), (k_ms, p_ms, readings, b_ms, b_by, work) in timed.items():
        log("jumper", f"render_frame (mode {mode}, NC {NC}) at N={NUM_ENVS}: kernel "
            f"{k_ms:.4f} ms, plain torch {p_ms:.4f} ms (kernel, plain, kernel: "
            f"{readings}), bound {b_ms:.4f} ms ({b_by}; {work}), the kernel at "
            f"{100 * b_ms / k_ms:.1f}% of it, on {card}; <BG_CROP> instance: "
            f"{occ[(mode, NC)]}")

    gym_centred("jumper", card, np, torch)
    keys = gpu_matches_cpu("jumper", np, torch, states=True)
    checked = replay_on_card("jumper_easy")
    log("jumper", f"64 envs x {CPU_STEPS} steps: GPU and CPU bit-equal (obs, rewards, "
        f"firsts, {', '.join(keys)}); jumper_easy replay exact ({checked} steps)")
    kernel_ms, plain_ms, _, b_ms, b_by, _ = timed[(0, 20)]
    return (carry, step, wall_ms), frame_row("jumper", launches, err, kernel_ms,
                                             plain_ms, b_ms, b_by)


def caveflyer_phase(dev, card, np, torch):
    """Caveflyer: the whole-frame kernel at its largest blocks, the whole
    world of 30, 40 and 60 cells (memory's: 151 entity slots and 32 decor
    slots over a 60x60 window) and the centred windows of 13 and 19 cells,
    the ship, its bullets and exhaust on the 32-bucket rotation banks.
    The slice first; then ``render_frame`` against its plain version on
    the prep of the slice's 4096 easy states and of 4096 hard and 4096
    memory states after 20 steps, each under both cameras, on the slice's
    states with every slot of both pools turned to angles from -10^4 to
    10^4 rad, and on 4096 envs of edge-case slots at memory's caps in its
    whole-world window; the kernel's time and bound in each window and
    each instance's occupancy; the centred ``ProcgenGym3Env``; card against
    CPU; the three recordings.  Returns ((carry, step, ms a step), the
    kernels line's row)."""
    from procgen_tpu_torch.core import lifecycle
    from procgen_tpu_torch.core.constants import INT32_MAX, MEMORY_MODE
    from procgen_tpu_torch.core.options import GameOptions
    from procgen_tpu_torch.games.caveflyer import Caveflyer
    from procgen_tpu_torch.render import render_kernel as rk

    def game_of(mode, centred):
        game = Caveflyer(GameOptions(distribution_mode=mode, center_agent=centred))
        game.level_seed_low, game.level_seed_high = 0, INT32_MAX
        return game

    # the main path
    carry, launches, step, wall_ms = run_slice("caveflyer", dev, card, np, torch)
    total = WARM_STEPS + TIMED_STEPS
    if launches["render_frame"] != total or launches["render_suffix"] != 0:
        raise AssertionError(f"caveflyer: launches {launches} in {total} steps")

    # kernel vs plain version under both cameras: the slice's easy states,
    # hard and memory states after 20 steps (shots a third of the time)
    seeds = torch.as_tensor(np.random.RandomState(81).randint(0, 2**31, NUM_ENVS),
                            dtype=torch.int64, device=dev)
    rng = np.random.RandomState(1)
    err, timed, occ, live = 0, {}, {}, {}
    for mode in (0, 1, MEMORY_MODE):
        if mode == 0:
            st = carry.states
        else:
            game = game_of(mode, False)
            st = lifecycle.env_reset(game, lifecycle.initial_state(game, seeds))
            for _ in range(20):
                acts = np.where(rng.rand(NUM_ENVS) < 0.33, 9, rng.randint(0, 9, NUM_ENVS))
                st, _ = lifecycle.env_step(game, st, torch.as_tensor(acts, device=dev))
        live[mode] = (int(st.ents.count.sum()), int(st.decor.count.sum()))
        for centred in (False, True):
            game = game_of(mode, centred)
            plan = rk.get_plan(game)
            want_nc = int(game.visibility) + 3 if centred else game.world_dim
            x = rk.prep_frame(plan, st)
            if plan.static or x.gtab.shape[1] != want_nc:
                raise AssertionError(f"caveflyer mode {mode}: window of {x.gtab.shape[1]} cells")
            err = max(err, frame_check(x, f"caveflyer mode {mode} states (NC {want_nc})", rk,
                                       torch))
            timed[(mode, want_nc)] = (*time_frame(x, rk), *frame_bound(x, rk, torch))
            occ[(mode, want_nc)] = occupancy(rk.frame_occupancy(x))
            del x
        if mode > 0:
            del st

    # every slot of both pools of the slice's states turned: quarter turns,
    # angles within 1e-4 of them, the banks' bucket edges, any angle
    turned, banked = rk.turned_states(carry.states, 81), 0
    for centred in (False, True):
        plan = rk.get_plan(game_of(0, centred))
        x = rk.prep_frame(plan, turned)
        first = plan.ent_atlas.transparent_row + 1
        for xi in (x.ent_i, x.dec_i):
            row = xi[..., rk.EI_ROW]
            banked += int(((row >= first) & (row < plan.n1e) & (xi[..., rk.EI_LIVE] > 0)).sum())
        err = max(err, frame_check(x, f"turned caveflyer states (NC {plan.NC})", rk, torch))
        del x
    del turned
    mem = rk.get_plan(game_of(MEMORY_MODE, False))
    err = max(err, edge_frame_check(mem, mem.game.ENT_CAP, mem.game.DECOR_CAP, 81, rk, torch))
    log("caveflyer", f"render_frame byte-equal: {NUM_ENVS} states of each mode (0: the "
        f"slice's, 1 and 10: after 20 steps; live entity and decor slots by mode: {live}) "
        f"under the whole-world camera and the centred one (windows by (mode, NC): "
        f"{list(timed)}), the slice's states with both pools turned (the easy windows; "
        f"{banked} live slots on bank rows), {NUM_ENVS} envs of edge-case slots with both "
        f"pools full ({mem.game.ENT_CAP} + {mem.game.DECOR_CAP}) in memory's whole-world "
        f"window (NC {mem.NC}); max_abs_err {err}")
    for (mode, NC), (k_ms, p_ms, readings, b_ms, b_by, work) in timed.items():
        log("caveflyer", f"render_frame (mode {mode}, NC {NC}) at N={NUM_ENVS}: kernel "
            f"{k_ms:.4f} ms, plain torch {p_ms:.4f} ms (kernel, plain, kernel: "
            f"{readings}), bound {b_ms:.4f} ms ({b_by}; {work}), the kernel at "
            f"{100 * b_ms / k_ms:.1f}% of it, on {card}; <BG_CROP> instance: "
            f"{occ[(mode, NC)]}")

    gym_centred("caveflyer", card, np, torch)
    keys = gpu_matches_cpu("caveflyer", np, torch, states=True)
    checked = [replay_on_card(f"caveflyer_{m}") for m in ("easy", "hard", "memory")]
    log("caveflyer", f"64 envs x {CPU_STEPS} steps: GPU and CPU bit-equal (obs, rewards, "
        f"firsts, {', '.join(keys)}); caveflyer_easy, _hard and _memory replays exact "
        f"({checked} steps)")
    kernel_ms, plain_ms, _, b_ms, b_by, _ = timed[(0, 30)]
    return (carry, step, wall_ms), frame_row("caveflyer", launches, err, kernel_ms,
                                             plain_ms, b_ms, b_by)


def mono_phase(dev, card, np, torch):
    """Monochrome sprites: every slot on the kernels' fallback-colour branch
    and the grid drawn without a tile atlas.  ``render_frame`` against its
    plain version on the prep of 4096 coinrun states (whole world and
    centred) and 4096 chaser states after 20 steps, ``render_suffix`` on
    4096 maze states after 20 steps (their prefix frames drawn with
    coloured cells at the reset); each kernel's time and bound; the
    coinrun_mono and chaser_mono recordings replayed on the card with the
    ``render_frame`` launches counted, and 30 steps of a 4096-env maze
    ``ProcgenGym3Env(use_monochrome_assets=True)`` with the
    ``render_suffix`` launches counted.  Returns the kernels line's rows."""
    from procgen_tpu_torch import ProcgenGym3Env
    from procgen_tpu_torch.core import lifecycle
    from procgen_tpu_torch.core.constants import INT32_MAX
    from procgen_tpu_torch.core.options import GameOptions
    from procgen_tpu_torch.games.registry import make_game
    from procgen_tpu_torch.render import render_kernel as rk

    def game_of(name, centred):
        game = make_game(name, GameOptions(distribution_mode=0, center_agent=centred,
                                           use_monochrome_assets=True))
        game.level_seed_low, game.level_seed_high = 0, INT32_MAX
        return game

    seeds = torch.as_tensor(np.random.RandomState(91).randint(0, 2**31, NUM_ENVS),
                            dtype=torch.int64, device=dev)
    rng = np.random.RandomState(1)
    err, timed = 0, {}
    for name, cams in (("coinrun", (False, True)), ("chaser", (False,)), ("maze", (False,))):
        game = game_of(name, False)
        s = lifecycle.env_reset(game, lifecycle.initial_state(game, seeds))
        for _ in range(PRE_STEPS):
            s, _ = lifecycle.env_step(game, s, torch.as_tensor(rng.randint(0, 15, NUM_ENVS),
                                                               device=dev))
        for centred in cams:
            plan = rk.get_plan(game_of(name, centred))
            what = f"{name}{' centred' if centred else ''}"
            if plan.ent_atlas is not None or plan.S != 2:
                raise AssertionError(f"{what} mono: an entity atlas")
            if plan.static:
                ent_f, ent_i, decor = rk.prep_suffix(plan, s)
                fb = ent_i[..., rk.EI_FB]
                base = s.frame.contiguous()
                atlas = plan.atlas(dev)
                nz = len(plan.z_levels)
                err = max(err, suffix_check(base, ent_f, ent_i, atlas, nz, decor,
                                            f"{what} mono states", rk, torch))
                k_ms, p_ms, readings = suffix_times(base, ent_f, ent_i, atlas, nz, decor, rk)
                b = suffix_bound(base, ent_f, ent_i, atlas, nz, decor, rk, torch,
                                 count=s.ents.count)
            else:
                x = rk.prep_frame(plan, s)
                fb = x.ent_i[..., rk.EI_FB]
                if plan.grid_atlas is not None or int(x.gtab.abs().sum()) != 0:
                    raise AssertionError(f"{what} mono: a grid atlas")
                err = max(err, frame_check(x, f"{what} mono states (NC {plan.NC})", rk, torch))
                k_ms, p_ms, readings = time_frame(x, rk)
                b = frame_bound(x, rk, torch)
                del x
            if not bool((fb == 1).all()):
                raise AssertionError(f"{what} mono: a slot off the fallback branch")
            timed[what] = (k_ms, p_ms, readings, *b)
        del s
    for what, (k_ms, p_ms, readings, b_ms, b_by, work) in timed.items():
        log("mono", f"{'render_suffix' if what == 'maze' else 'render_frame'} ({what} "
            f"mono) at N={NUM_ENVS}: kernel {k_ms:.4f} ms, plain torch {p_ms:.4f} ms "
            f"(kernel, plain, kernel: {readings}), bound {b_ms:.4f} ms ({b_by}; {work}), "
            f"the kernel at {100 * b_ms / k_ms:.1f}% of it, on {card}")
    log("mono", f"byte-equal on {NUM_ENVS} monochrome states after {PRE_STEPS} steps of "
        f"coinrun (whole world, centred), chaser and maze (suffix), every slot on the "
        f"fallback-colour branch; max_abs_err {err}")

    # the main paths: the two recordings and the maze gym3 surface
    path_launches = {}
    for rec in ("coinrun_mono", "chaser_mono"):
        zero_counts(rk)
        checked = replay_on_card(rec, "conformance_opts")
        path_launches[rec] = dict(rk.LAUNCHES)
        if path_launches[rec]["render_frame"] < checked:
            raise AssertionError(f"{rec}: launches {path_launches[rec]} in {checked} steps")
    env = ProcgenGym3Env(num=NUM_ENVS, env_name="maze", distribution_mode="easy",
                         rand_seed=0, device="cuda", use_monochrome_assets=True)
    acts = np.random.RandomState(5).randint(0, 15, size=(GYM_TIMED_STEPS, NUM_ENVS))
    zero_counts(rk)
    for a in acts:
        env.act(a.astype(np.int32))
        _, obs, _ = env.observe()
    path_launches["maze_mono"] = dict(rk.LAUNCHES)
    if path_launches["maze_mono"]["render_suffix"] != GYM_TIMED_STEPS \
            or obs["rgb"].shape != (NUM_ENVS, 64, 64, 3):
        raise AssertionError(f"maze mono gym3: launches {path_launches['maze_mono']}")
    del env
    log("mono", f"coinrun_mono and chaser_mono replays exact on the card; launches on "
        f"the main paths (the replays, {GYM_TIMED_STEPS} act + observe steps of a "
        f"{NUM_ENVS}-env maze ProcgenGym3Env): {path_launches}")
    rows = [frame_row(f"{name}_mono", path_launches[f"{name}_mono"], err,
                      *timed[what][:2], *timed[what][3:5])
            for name, what in (("coinrun", "coinrun centred"), ("chaser", "chaser"))]
    k_ms, p_ms, _, b_ms, b_by, _ = timed["maze"]
    rows.append({
        "name": "render_suffix",
        "path": "maze_mono",
        "route": "cuda",
        "source": "procgen_tpu_torch/csrc/render_suffix.cu",
        "replaces": "procgen_tpu/render/pallas_kernel.py:1136",
        "launches": path_launches["maze_mono"]["render_suffix"],
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    })
    return rows


# memory mode's states for the kernel checks: (game, random steps after
# the reset); miner's gravity sweep over its 35x35 world is a host loop of
# small operations for every cell, so its states come after fewer steps
MEMORY_STATES = (("maze", 20), ("miner", 3), ("dodgeball", 20))


def memory_phase(dev, card, np, torch):
    """Memory mode: the whole-frame kernel on the agent-centred window of
    ``visibility + 3`` cells (11 for maze and miner, 19 for dodgeball with
    both pools) against its plain version on the prep of 4096 memory
    states of each game and on edge-case slots at dodgeball's caps in its
    window; the kernel's time and bound on maze's and dodgeball's states;
    64-env maze memory on the card against the CPU; the maze_memory
    recording replayed on the card, the path's launches counted in it (no
    timed slice).  Returns the kernels line's row."""
    from procgen_tpu_torch.core import lifecycle
    from procgen_tpu_torch.core.constants import MEMORY_MODE
    from procgen_tpu_torch.render import render_kernel as rk

    seeds = torch.as_tensor(np.random.RandomState(41).randint(0, 2**31, NUM_ENVS),
                            dtype=torch.int64, device=dev)
    rng = np.random.RandomState(2)
    err, timed, occ = 0, {}, {}
    for name, steps in MEMORY_STATES:
        game = _game(name, MEMORY_MODE)
        s = lifecycle.env_reset(game, lifecycle.initial_state(game, seeds))
        for _ in range(steps):
            acts = torch.as_tensor(rng.randint(0, 15, size=NUM_ENVS), device=dev)
            s, _ = lifecycle.env_step(game, s, acts)
        plan = rk.get_plan(game)
        x = rk.prep_frame(plan, s)
        NC = x.gtab.shape[1]
        if plan.static or NC != int(game.visibility) + 3:
            raise AssertionError(f"{name} memory: window of {NC} cells")
        err = max(err, frame_check(x, f"{name} memory states (NC = {NC})", rk, torch))
        occ[name] = occupancy(rk.frame_occupancy(x))
        if name != "miner":
            timed[name] = (NC, int(s.ents.count.sum()), *time_frame(x, rk),
                           *frame_bound(x, rk, torch))
        if name == "dodgeball":
            err = max(err, edge_frame_check(plan, game.ENT_CAP, game.DECOR_CAP, 43, rk,
                                            torch))
        del s, x
    for name, (NC, live, k_ms, p_ms, readings, b_ms, b_by, work) in timed.items():
        log("memory", f"render_frame ({name} memory, NC = {NC}) at N={NUM_ENVS} "
            f"({live} live slots): kernel {k_ms:.4f} ms, plain torch {p_ms:.4f} ms "
            f"(kernel, plain, kernel: {readings}), bound {b_ms:.4f} ms ({b_by}; "
            f"{work}), the kernel at {100 * b_ms / k_ms:.1f}% of it, on {card}")
    log("memory", f"render_frame byte-equal on {NUM_ENVS} memory states of "
        f"{[n for n, _ in MEMORY_STATES]} and {NUM_ENVS} envs of edge-case slots at "
        f"dodgeball's caps in its 19-cell window; max_abs_err {err}; instances: "
        + "; ".join(f"{k}: {v}" for k, v in occ.items()))

    keys = gpu_matches_cpu("maze", np, torch, states=True, **MEMORY)
    zero_counts(rk)
    checked = replay_on_card("maze_memory")
    launches = dict(rk.LAUNCHES)
    if launches["render_frame"] < checked or launches["render_suffix"] != 0:
        raise AssertionError(f"maze memory: launches {launches} in {checked} steps")
    log("memory", f"64 envs x 50 steps of maze memory: GPU and CPU bit-equal (obs, "
        f"rewards, firsts, {', '.join(keys)}); maze_memory replay exact ({checked} "
        f"steps, {launches['render_frame']} render_frame launches)")
    NC, _, k_ms, p_ms, _, b_ms, b_by, _ = timed["maze"]
    return frame_row("memory", launches, err, k_ms, p_ms, b_ms, b_by)


def painter_ops(vals, torch):
    """f32 operations ``assetgen_bg`` needs on these words (int64 [N,
    N_MAX] on the card): 4 a word used (its conversion and the formula it
    feeds); for each paint, 2 a row and a column of its span (the edge
    tests) for a fill or a blend and 6 for an ellipse (the offset, the
    division and the square of both ellipses), then 4 a pixel of an
    ellipse's span (the sums and the tests) and 9 a pixel a blend covers
    (two products and a sum a channel); 6 a pixel at the end (the round and
    the clip of each channel).  The paints come from the plain version's
    walk, 512 envs at a time."""
    from procgen_tpu_torch.core import assetgen as ag

    g = (torch.arange(128, dtype=torch.float32, device=vals.device) + 0.5) * (500.0 / 128)
    total = 0
    for e0 in range(0, vals.shape[0], 512):
        (kind, rect, _, _, _), used = ag._paints(vals[e0:e0 + 512])
        x, y, w, h = (rect[..., k, None] for k in range(4))
        a = torch.clamp_min(w * 0.5, ag.EPS)
        b = torch.clamp_min(h * 0.5, ag.EPS)
        ell = (kind == ag.ELLIPSE)[..., None]
        rows = torch.where(ell, ((g - (y + h * 0.5)) / b) ** 2 <= 1.0,
                           (g >= y) & (g < y + h)).sum(-1)
        cols = torch.where(ell, ((g - (x + w * 0.5)) / a) ** 2 <= 1.0,
                           (g >= x) & (g < x + w)).sum(-1)
        ell = ell[..., 0]
        per = torch.where(ell, 6 * (rows + cols) + 4 * rows * cols, 2 * (rows + cols))
        per = per + torch.where(kind == ag.BLEND, 9 * rows * cols, 0)
        total += int(per[kind > 0].sum()) + 4 * int(used.sum())
    return total + 6 * 3 * 128 * 128 * vals.shape[0]


def painter_bound(vals, used, torch, ops=True):
    """(bound_ms, bound_by, work) of ``assetgen_bg``: the words each env
    used read once (int64 each) and the canvases and the words used
    written, against ``painter_ops`` (not counted with ``ops=False``: the
    bytes then decide the bound by themselves).  The serial walk's latency
    is timed apart."""
    moved = 8 * int(used.sum()) + vals.shape[0] * (128 * 128 * 3 + 4)
    if not ops:
        return (*bound(moved, 0), f"{moved} bytes, operations not counted")
    ops = painter_ops(vals, torch)
    return (*bound(moved, ops), f"{moved} bytes, {ops} f32 ops")


def gym_genassets(name, dev, card, np, torch, baseline=False, timed=GENASSETS_TIMED_STEPS):
    """The gym3 surface with generated assets at full width, act + observe,
    the centred camera: ``timed`` timed steps after 10.  The
    launch counts are zeroed just before each stretch of this env's work
    (its making, its steps) and read just after.  With ``baseline``, the
    same env without generated assets is made beside it and both are timed
    in alternating windows (without, with, with, without) on the same
    actions; coinrun's step split follows for each.  Returns the launches
    of the kernels and the env-steps/s (with, and without or None)."""
    from collections import Counter

    from procgen_tpu_torch import ProcgenGym3Env
    from procgen_tpu_torch.core import assetgen
    from procgen_tpu_torch.render import render_kernel as rk

    launches = Counter()

    def counted(fn):
        zero_counts(rk, assetgen)
        out = fn()
        launches.update({**rk.LAUNCHES, **assetgen.LAUNCHES})
        return out

    def make(gen):
        t0 = time.perf_counter()
        env = ProcgenGym3Env(num=NUM_ENVS, env_name=name, distribution_mode="easy",
                             rand_seed=0, device=dev, use_generated_assets=gen)
        torch.cuda.synchronize()
        return env, time.perf_counter() - t0

    def run(env, acts_):
        out = None
        for a in acts_:
            env.act(a)
            out = env.observe()
        return out

    def window(env, acts_):  # seconds of these steps; observe copies to the host
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(env, acts_)
        return time.perf_counter() - t0, out

    acts = np.random.RandomState(5).randint(0, 15, size=(10 + timed, NUM_ENVS))
    acts = acts.astype(np.int32)
    warm, half = acts[:10], (acts[10:10 + timed // 2], acts[10 + timed // 2:])
    env, t_init = counted(lambda: make(True))
    counted(lambda: run(env, warm))
    envs = {True: env}
    if baseline:
        envs[False], _ = make(False)
        run(envs[False], warm)
    secs = {True: 0.0, False: 0.0}
    order = ((False, 0), (True, 0), (True, 1), (False, 1)) if baseline else ((True, 0), (True, 1))
    for gen, h in order:
        if gen:
            dt, (rew_, obs_, _) = counted(lambda: window(env, half[h]))
        else:
            dt, _ = window(envs[False], half[h])
        secs[gen] += dt
    rgb = obs_["rgb"]
    if rgb.shape != (NUM_ENVS, 64, 64, 3) or rgb.dtype != np.uint8 or not np.isfinite(rew_).all():
        raise AssertionError(f"gym3 {name} genassets: obs {rgb.shape} {rgb.dtype}")
    # 2 painter launches make the envs (states and pool), so a third is a
    # reset's replenish chunk
    if launches["render_frame"] != 10 + timed or launches["assetgen_bg"] <= 2:
        raise AssertionError(f"gym3 {name} genassets: launches {dict(launches)} in "
                             f"{10 + timed} steps")
    rates = {gen: timed * NUM_ENVS / secs[gen] for gen in envs}
    for gen in envs:
        if name == "coinrun":
            # the layers of this configuration's step and its torch operations
            actions = torch.as_tensor(acts[:SPLIT_STEPS], device=dev)
            split, ops = step_split(envs[gen]._vec.carry, actions, name, torch,
                                    envs[gen]._vec.game)
            log("genassets", f"{name} centred, generated assets {gen}, step split "
                f"(synchronised, ms/step): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
                + "; torch operations dispatched (a count): "
                + ", ".join(f"{k} {v}" for k, v in ops.items()))
        log("genassets", f"ProcgenGym3Env({name}, use_generated_assets={gen}) centred: "
            f"{rates[gen]:.1f} env-steps/s ({secs[gen] / timed * 1e3:.2f} ms per "
            f"act+observe, {NUM_ENVS} envs, {timed} timed steps after 10"
            f"{' in alternating windows' if baseline else ''}, obs copied to the host"
            f"{f'; init {t_init:.2f}s' if gen else ''}) on {card}")
    log("genassets", f"{name} with generated assets: launches {dict(launches)} from the "
        f"envs' making to the last step")
    return launches, rates[True], rates.get(False)


def painter_seeds(np):
    """The seeds of the painter checks: 256 seeded streams, and the
    4096 of the timed batch."""
    return (np.random.RandomState(21).randint(0, 2**31, 256),
            np.random.RandomState(22).randint(0, 2**31, NUM_ENVS))


def painter_edge_envs():
    """The envs of the 4096-env batch within 4 of each 1024-env chunk
    edge of ``assetgen_bg``."""
    return [e for b in range(0, NUM_ENVS + 1, 1024) for e in range(b - 4, b + 4)
            if 0 <= e < NUM_ENVS]


def painter_blocks(np, torch, device):
    """The draw blocks of the 256 seeded streams and the longest path's
    words (int64 [257, N_MAX]) on ``device``."""
    from procgen_tpu_torch.core import assetgen, rng

    seeds = torch.as_tensor(painter_seeds(np)[0], dtype=torch.int64, device=device)
    vals, _ = rng.draw_block(rng.seed(seeds), assetgen.N_MAX)
    longest = torch.as_tensor(assetgen.longest_path_words(0), device=device)[None]
    return torch.cat([vals, longest]).contiguous()


def word_sum(vals, torch):
    """A checksum of draw blocks: each word times its flat position plus
    one, summed modulo 2^64 (the same on the CPU and the card)."""
    pos = torch.arange(1, vals.numel() + 1, dtype=torch.int64, device=vals.device)
    return int((vals.reshape(-1) * pos).sum())


def painter_refs(np, torch):
    """The CPU halves of the painter checks: the plain painter on the
    blocks of ``painter_blocks`` and on the chunk-edge envs of the 4096
    batch, each as (checksum of the words, canvases, words used), the
    arrays numpy's (a tensor sent through a queue is shared through the
    sender's file descriptors, which close when the worker ends)."""
    from procgen_tpu_torch.core import assetgen, rng

    vals = painter_blocks(np, torch, "cpu")
    seeds = torch.as_tensor(painter_seeds(np)[1][painter_edge_envs()], dtype=torch.int64)
    edge_vals, _ = rng.draw_block(rng.seed(seeds), assetgen.N_MAX)
    return tuple((word_sum(v, torch), *(t.numpy() for t in
                                        assetgen.generate_background_reference(v)))
                 for v in (vals, edge_vals))


PAINTER_THREADS = 2
_PAINTER = {}  # the painter worker: its process and queue


def painter_worker(queue):
    """``painter_refs`` in a process of its own, started with the CPU
    worker, so that the genassets phase does not wait for the CPU."""
    import numpy as np
    import torch

    torch.set_num_threads(PAINTER_THREADS)
    t0 = time.perf_counter()
    queue.put((painter_refs(np, torch), time.perf_counter() - t0))


def start_painter_worker(only=None):
    import multiprocessing

    if only is not None and "genassets" not in only:
        return
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=painter_worker, args=(queue,), daemon=True)
    proc.start()
    _PAINTER.update(proc=proc, queue=queue)


def painter_result():
    """The painter worker's result (waited for), the seconds it took and
    the seconds this process waited."""
    import queue

    t0 = time.perf_counter()
    while True:
        try:
            refs, secs = _PAINTER["queue"].get(timeout=5)
            return refs, secs, time.perf_counter() - t0
        except queue.Empty:
            if not _PAINTER["proc"].is_alive():
                raise RuntimeError(f"the painter worker ended (exit code "
                                   f"{_PAINTER['proc'].exitcode}) without a result")


def genassets_phase(dev, card, np, torch):
    """Generated assets: the painter, the painted canvas in render_frame,
    the gym3 path, card against CPU, the recording.  Returns the kernels
    line's rows."""
    from procgen_tpu_torch.core import lifecycle, rng
    from procgen_tpu_torch.core.constants import INT32_MAX
    from procgen_tpu_torch.core.options import GameOptions
    from procgen_tpu_torch.games.registry import make_game
    from procgen_tpu_torch.core import assetgen
    from procgen_tpu_torch.render import render_kernel as rk

    # the painter against its plain version, which the painter worker ran
    # on the CPU on the same words
    t0 = time.perf_counter()
    refs, secs, waited = painter_result()
    vals = painter_blocks(np, torch, dev)
    longest = vals[-1:].contiguous()
    saved = dict(assetgen.LAUNCHES)
    got_c, got_u = assetgen.generate_background(vals)
    torch.cuda.synchronize()
    assetgen.LAUNCHES.update(saved)
    (sum_w, want_c, want_u), (edge_sum, edge_c, edge_u) = (
        (w, torch.from_numpy(c), torch.from_numpy(u)) for w, c, u in refs)
    if word_sum(vals, torch) != sum_w:
        raise AssertionError("the card's draw blocks differ from the CPU's")
    perr = int((got_c.cpu().int() - want_c.int()).abs().max())
    if perr != 0 or not torch.equal(got_u.cpu(), want_u):
        raise AssertionError(f"assetgen_bg != plain (max err {perr}, words used "
                             f"equal: {torch.equal(got_u.cpu(), want_u)})")
    if int(got_u[-1]) != 50701:
        raise AssertionError(f"the longest path used {int(got_u[-1])} words")
    log("genassets", f"assetgen_bg byte-equal: 256 seeded draw blocks (words used "
        f"{int(want_u[:-1].min())}-{int(want_u[:-1].max())}, mean "
        f"{float(want_u[:-1].float().mean()):.1f}) and the longest path (50701 "
        f"words, {assetgen.MAX_PAINTS} paints); max_abs_err {perr} "
        f"({time.perf_counter() - t0:.1f} s; the painter worker's plain versions "
        f"took {secs:.1f} s on the CPU, waited for {waited:.1f} s)")

    # its time: a replenish chunk (64 envs), the initial reset (4096), one
    # env (the serial walk's latency), against the plain version at 64
    big_seeds = torch.as_tensor(painter_seeds(np)[1], dtype=torch.int64, device=dev)
    v4096, _ = rng.draw_block(rng.seed(big_seeds), assetgen.N_MAX)
    v4096 = v4096.contiguous()
    v64 = v4096[:64].contiguous()
    saved = dict(assetgen.LAUNCHES)
    k64a = cuda_ms(lambda: assetgen.generate_background(v64), 20)
    k4096 = cuda_ms(lambda: assetgen.generate_background(v4096), 3)
    k64b = cuda_ms(lambda: assetgen.generate_background(v64), 20)
    k1 = cuda_ms(lambda: assetgen.generate_background(v64[:1]), 20)
    k1_long = cuda_ms(lambda: assetgen.generate_background(longest), 20)
    t1 = time.perf_counter()
    _, u64 = assetgen.generate_background_reference(v64)
    torch.cuda.synchronize()
    p64 = (time.perf_counter() - t1) * 1e3  # host-bound: one synchronised call
    _, u64 = assetgen.generate_background(v64)
    c4096, u4096 = assetgen.generate_background(v4096)
    assetgen.LAUNCHES.update(saved)
    k64 = (k64a + k64b) / 2
    b64, b64_by, b64_work = painter_bound(v64, u64, torch)
    b4096, b4096_by, b4096_work = painter_bound(v4096, u4096, torch, ops=False)
    # the initial reset's 4096 envs go through the kernel's chunks of 1024,
    # one paint scratch reused: the envs on each side of every chunk edge
    # against the plain version (the painter worker's)
    t1 = time.perf_counter()
    edge = torch.tensor(painter_edge_envs(), device=dev)
    if word_sum(v4096[edge], torch) != edge_sum:
        raise AssertionError("the card's draw blocks differ from the CPU's at the edges")
    perr = max(perr, int((c4096[edge].cpu().int() - edge_c.int()).abs().max()))
    if perr != 0 or not torch.equal(u4096[edge].cpu(), edge_u):
        raise AssertionError(f"assetgen_bg at {NUM_ENVS} envs != plain on the chunk edges "
                             f"(max err {perr})")
    log("genassets", f"assetgen_bg at {NUM_ENVS} envs byte-equal on the {edge.numel()} "
        f"envs at its chunk edges (envs {edge.tolist()}); max_abs_err {perr} "
        f"({time.perf_counter() - t1:.1f} s)")
    log("genassets", f"assetgen_bg: 64 envs {k64:.4f} ms ({k64a:.4f}, {k64b:.4f}), "
        f"plain torch on the card {p64:.1f} ms, bound {b64:.5f} ms ({b64_by}; "
        f"{b64_work}); 4096 envs {k4096:.4f} ms, bound {b4096:.5f} ms ({b4096_by}; "
        f"{b4096_work}); one env {k1:.4f} ms ({int(u64[0])} words), the longest "
        f"path alone {k1_long:.4f} ms (the serial walk's latency) on {card}")
    del vals, got_c, want_c, edge_c, v4096, c4096

    # render_frame on the painted canvas against its plain version
    def game_of(name, centred):
        game = make_game(name, GameOptions(distribution_mode=0, center_agent=centred,
                                           use_generated_assets=True))
        game.level_seed_low, game.level_seed_high = 0, INT32_MAX
        game.fixed_asset_seed = 1234
        return game

    err = 0
    timings = {}
    arng = np.random.RandomState(1)
    for name, cams in (("coinrun", (False, True)), ("fruitbot", (False,)),
                       ("miner", (False,)), ("starpilot", (False,))):
        game = game_of(name, False)
        s = lifecycle.env_reset(game, lifecycle.initial_state(game, big_seeds))
        for _ in range(PRE_STEPS):
            acts = torch.as_tensor(arng.randint(0, 15, size=NUM_ENVS), device=dev)
            s, _ = lifecycle.env_step(game, s, acts)
        for centred in cams:
            plan = rk.get_plan(game_of(name, centred))
            x = rk.prep_frame(plan, s)
            if not x.per_env_bg or x.bg_mode != (rk.BG_TILED if name == "fruitbot"
                                                 else rk.BG_CROP):
                raise AssertionError(f"{name}: not the painted canvas ({x.bg_mode})")
            err = max(err, frame_check(x, f"painted {name} states (centred "
                                       f"{centred})", rk, torch))
            if name == "coinrun" and not centred:
                # the edge cases over the envs' painted canvases
                err = max(err, edge_frame_check(
                    plan, plan.game.ENT_CAP, plan.game.DECOR_CAP, 25, rk, torch,
                    bg_atlas=x.bg_atlas))
            if name in ("coinrun", "fruitbot"):
                what = f"{name}{' centred' if centred else ''}"
                k_ms, p_ms, readings = time_frame(x, rk)
                b_ms, b_by, b_work = frame_bound(x, rk, torch)
                # the atlas background's kernel on the same states
                std = make_game(name, GameOptions(distribution_mode=0, center_agent=centred))
                xa = rk.prep_frame(rk.get_plan(std), s)
                ka_ms, _, areadings = time_frame(xa, rk)
                timings[what] = (k_ms, p_ms, b_ms, b_by)
                log("genassets", f"render_frame on painted {what} at N={NUM_ENVS} "
                    f"({int(s.ents.count.sum())} live slots): kernel {k_ms:.4f} ms, "
                    f"plain torch {p_ms:.4f} ms ({readings}), bound {b_ms:.4f} ms "
                    f"({b_by}; {b_work}); the atlas background on the same states "
                    f"{ka_ms:.4f} ms ({areadings}) on {card}")
        del s
    log("genassets", f"render_frame byte-equal on the painted canvas: {NUM_ENVS} "
        f"states after {PRE_STEPS} steps each of coinrun (whole-world and centred cameras), "
        f"fruitbot (tiled), miner and starpilot (cropped), and {NUM_ENVS} envs of "
        f"edge-case slots over coinrun's canvases; max_abs_err {err}")

    # the main paths: the gym3 surface with generated assets
    launches, _, _ = gym_genassets("coinrun", dev, card, np, torch, baseline=True)
    f_launches, _, _ = gym_genassets("fruitbot", dev, card, np, torch, timed=40)

    keys = gpu_matches_cpu("maze", np, torch, states=True, use_generated_assets=True)
    keys_c = gpu_matches_cpu("coinrun", np, torch, states=True, use_generated_assets=True)
    checked = replay_on_card("maze_genassets", "conformance_opts")
    log("genassets", f"64 envs x 50 steps, generated assets: GPU and CPU bit-equal "
        f"(maze: obs, rewards, firsts, {', '.join(keys)}; coinrun centred: "
        f"{', '.join(keys_c)}; bg_canvas among the leaves); maze_genassets replay "
        f"exact ({checked} steps)")

    return [
        frame_row("coinrun_genassets", launches, err, *timings["coinrun centred"]),
        frame_row("fruitbot_genassets", f_launches, err, *timings["fruitbot"]),
        {
            "name": "assetgen_bg",
            "path": "coinrun_genassets",
            "route": "cuda",
            "source": "procgen_tpu_torch/csrc/assetgen_bg.cu",
            "replaces": "procgen_tpu/render/assetgen.py:214",
            "launches": launches["assetgen_bg"],
            "max_abs_err": perr,
            "ms": k64,
            "plain_ms": p64,
            "bound_ms": b64,
            "bound_by": b64_by,
            "library_ms": None,
        },
    ]


# the surfaces phase: the 64-env blob run's steps, the rgb_array env's
# envs and steps, the joint env's warm-up and timed steps, the restored
# env's replay and rollout_full's steps
SURFACE_BLOB_STEPS = 20
HIRES_ENVS = 16
HIRES_STEPS = 2
JOINT_WARM = 10
RESTORE_STEPS = 20
ROLLOUT_STEPS = 10


def surface_outputs(device, np):
    """The runs of the surfaces phase held card against CPU: the blobs of a
    64-env maze ``ProcgenGym3Env`` after ``SURFACE_BLOB_STEPS`` seeded
    steps (joined), and the 512x512 ``info["rgb"]`` of a ``HIRES_ENVS``-env
    coinrun one with ``render_mode="rgb_array"`` after its reset and each
    of ``HIRES_STEPS`` steps."""
    from procgen_tpu_torch import ProcgenGym3Env

    env = ProcgenGym3Env(num=64, env_name="maze", rand_seed=0, device=device,
                         distribution_mode="easy")
    arng = np.random.RandomState(7)
    for _ in range(SURFACE_BLOB_STEPS):
        env.act(arng.randint(0, 15, size=64).astype(np.int32))
    blobs = np.frombuffer(b"".join(env.get_state()), np.uint8)
    env = ProcgenGym3Env(num=HIRES_ENVS, env_name="coinrun", rand_seed=0, device=device,
                         distribution_mode="easy", render_mode="rgb_array")
    frames = [env._vec.observe()[3]["rgb"].cpu().numpy()]
    for _ in range(HIRES_STEPS):
        env.act(arng.randint(0, 15, size=HIRES_ENVS).astype(np.int32))
        frames.append(env._vec.observe()[3]["rgb"].cpu().numpy())
    return blobs, np.stack(frames)


def plain_obs(game, states, rk, torch):
    """The 64x64 frames of ``render_kernel.render_obs_batch`` with each
    kernel's plain version in its place."""
    plan = rk.get_plan(game)
    if plan.static:
        ent_f, ent_i, decor = rk.prep_suffix(plan, states)
        base = states.frame.contiguous()
        out = rk.render_suffix_reference(base, ent_f, ent_i, plan.atlas(base.device),
                                         len(plan.z_levels), decor)
    else:
        out = rk.render_frame_reference(rk.prep_frame(plan, states))
    return rk.post(game, states, out.to(torch.int32), 64).to(torch.uint8)


def surfaces_phase(dev, card, np, torch):
    """The gym3 surfaces beside the step (phase 20 of the docstring).
    Returns the kernels line's rows of the joint env's path."""
    from procgen_tpu_torch import ProcgenGym3Env
    from procgen_tpu_torch.parallel.vec import render_hires
    from procgen_tpu_torch.render import render_kernel as rk

    # the joint recordings
    checked = [replay_on_card(name) for name in
               ("joint_maze+miner_easy", "joint_bossfight+chaser+dodgeball_easy")]
    log("surfaces", f"joint_maze+miner_easy and joint_bossfight+chaser+dodgeball_easy "
        f"replays exact on the card ({checked[0]} and {checked[1]} steps)")

    # the joint env: its main path, counted; its frames against the plain versions
    t0 = time.perf_counter()
    env = ProcgenGym3Env(num=NUM_ENVS, env_name="maze,miner", distribution_mode="easy",
                         rand_seed=0, device="cuda")
    init_s = time.perf_counter() - t0
    acts = np.random.RandomState(5).randint(
        0, 15, size=(JOINT_WARM + GYM_TIMED_STEPS, NUM_ENVS)).astype(np.int32)
    for a in acts[:JOINT_WARM]:
        env.act(a)
        env.observe()
    zero_counts(rk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in acts[JOINT_WARM:]:
        env.act(a)
        _, obs, _ = env.observe()
    dt = time.perf_counter() - t0
    launches = dict(rk.LAUNCHES)
    if launches != {"render_suffix": GYM_TIMED_STEPS, "render_frame": GYM_TIMED_STEPS} \
            or obs["rgb"].shape != (NUM_ENVS, 64, 64, 3):
        raise AssertionError(f"joint maze,miner: launches {launches}, obs {obs['rgb'].shape}")
    dev_obs = env._vec.observe()[0]
    subs = env._vec.subs
    for gi, sub in enumerate(subs):
        if not torch.equal(dev_obs[gi::2], plain_obs(sub.game, sub.states, rk, torch)):
            raise AssertionError(f"joint maze,miner: {sub.game.name}'s frames differ "
                                 f"from the plain version's")
    log("surfaces", f"ProcgenGym3Env('maze,miner', {NUM_ENVS} envs): "
        f"{GYM_TIMED_STEPS * NUM_ENVS / dt:.1f} env-steps/s ({dt / GYM_TIMED_STEPS * 1e3:.2f} "
        f"ms per act+observe, {GYM_TIMED_STEPS} timed steps after {JOINT_WARM}, obs "
        f"copied to the host; construction {init_s:.2f} s) on {card}; launches {launches}; "
        f"the last step's frames equal both kernels' plain versions")

    # each kernel's time and bound on its sub-game's states
    maze, miner = subs
    plan = rk.get_plan(maze.game)
    ent_f, ent_i, decor = rk.prep_suffix(plan, maze.states)
    base = maze.states.frame.contiguous()
    atlas = plan.atlas(dev)
    nz = len(plan.z_levels)
    err = suffix_check(base, ent_f, ent_i, atlas, nz, decor, "joint maze states", rk, torch)
    s_ms, sp_ms, s_read = suffix_times(base, ent_f, ent_i, atlas, nz, decor, rk)
    sb_ms, sb_by, s_work = suffix_bound(base, ent_f, ent_i, atlas, nz, decor, rk, torch,
                                        count=maze.states.ents.count)
    x = rk.prep_frame(rk.get_plan(miner.game), miner.states)
    err = max(err, frame_check(x, "joint miner states", rk, torch))
    f_ms, fp_ms, f_read = time_frame(x, rk)
    fb_ms, fb_by, f_work = frame_bound(x, rk, torch)
    del x
    n_sub = NUM_ENVS // 2
    log("surfaces", f"render_suffix (joint maze, N={n_sub}): kernel {s_ms:.4f} ms, plain "
        f"{sp_ms:.4f} ms ({s_read}), bound {sb_ms:.4f} ms ({sb_by}; {s_work}); "
        f"render_frame (joint miner, N={n_sub}): kernel {f_ms:.4f} ms, plain {fp_ms:.4f} "
        f"ms ({f_read}), bound {fb_ms:.4f} ms ({fb_by}; {f_work}); on {card}")
    del env, maze, miner, subs, ent_f, ent_i, base, dev_obs, obs

    # get_state / set_state at full width, and a cross-seed replay
    a = ProcgenGym3Env(num=NUM_ENVS, env_name="maze", distribution_mode="easy",
                       rand_seed=0, device="cuda")
    b = ProcgenGym3Env(num=NUM_ENVS, env_name="maze", distribution_mode="easy",
                       rand_seed=1, device="cuda")
    acts = np.random.RandomState(6).randint(
        0, 15, size=(JOINT_WARM + RESTORE_STEPS, NUM_ENVS)).astype(np.int32)
    for x_ in acts[:JOINT_WARM]:
        a.act(x_)
    b.act(acts[0])
    get_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blobs = a.get_state()
        get_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b.set_state(blobs)
    torch.cuda.synchronize()
    set_ms = (time.perf_counter() - t0) * 1e3
    for x_ in acts[JOINT_WARM:]:
        a.act(x_)
        b.act(x_)
        oa, ob = a._vec.observe(), b._vec.observe()
        for u, v in zip(oa[:3], ob[:3]):
            if not torch.equal(u, v):
                raise AssertionError("maze: the restored env's replay diverged")
        for k in oa[3]:
            if not torch.equal(oa[3][k], ob[3][k]):
                raise AssertionError(f"maze: the restored env's {k} diverged")
    if a.get_state() != b.get_state():
        raise AssertionError("maze: the restored env's states differ after the replay")
    log("surfaces", f"maze {NUM_ENVS} envs: get_state {get_ms[0]:.1f} ms and "
        f"{get_ms[1]:.1f} ms ({len(blobs[0])} B an env), set_state {set_ms:.1f} ms "
        f"(the pool rebuilt: one env_reset of every env) on {card}; the restore into a "
        f"differently seeded env replays {RESTORE_STEPS} steps bit-equal")
    del a, b, blobs

    # card against CPU: blobs and the 512 frame; the 512 frame's time
    i = next_cpu_run(SURFACES)
    g_blobs, g_frames = surface_outputs("cuda", np)
    (c_blobs, c_frames), secs, waited = cpu_run(i)
    if not np.array_equal(g_blobs, c_blobs):
        raise AssertionError("maze: the 64-env blobs differ between the card and the CPU")
    if g_frames.shape != (HIRES_STEPS + 1, HIRES_ENVS, 512, 512, 3) \
            or not np.array_equal(g_frames, c_frames):
        raise AssertionError("coinrun: info['rgb'] differs between the card and the CPU")
    h = ProcgenGym3Env(num=HIRES_ENVS, env_name="coinrun", rand_seed=0, device="cuda",
                       distribution_mode="easy", render_mode="rgb_array")
    hv = h._vec
    h1 = cuda_ms(lambda: render_hires(hv.game, hv.states), 5)
    h2 = cuda_ms(lambda: render_hires(hv.game, hv.states), 5)
    log("surfaces", f"64-env maze blobs ({len(g_blobs)} B) after {SURFACE_BLOB_STEPS} "
        f"steps and the {HIRES_ENVS}-env coinrun info['rgb'] (512x512, reset and "
        f"{HIRES_STEPS} steps) equal on the card and the CPU (the CPU worker's run took "
        f"{secs:.1f} s, waited for {waited:.1f} s); the 512 frame: {h1:.2f} and {h2:.2f} "
        f"ms for {HIRES_ENVS} envs, {(h1 + h2) / 2 / HIRES_ENVS:.3f} ms an env on {card}")
    del h, hv

    # rollout_full against act + observe
    r = ProcgenGym3Env(num=64, env_name="maze", rand_seed=2, device="cuda",
                       distribution_mode="easy")
    s = ProcgenGym3Env(num=64, env_name="maze", rand_seed=2, device="cuda",
                       distribution_mode="easy")
    acts = np.random.RandomState(8).randint(0, 15, size=(ROLLOUT_STEPS, 64)).astype(np.int32)
    obs_r, rew_r, first_r, info_r = r._vec.rollout_full(acts)
    for t, x_ in enumerate(acts):
        s.act(x_)
        o, rw, f, inf = s._vec.observe()
        same = (torch.equal(obs_r[t], o) and torch.equal(rew_r[t], rw)
                and torch.equal(first_r[t], f) and sorted(inf) == sorted(info_r)
                and all(torch.equal(info_r[k][t], inf[k]) for k in inf))
        if not same:
            raise AssertionError(f"rollout_full differs from act + observe at step {t}")
    log("surfaces", f"rollout_full of {ROLLOUT_STEPS} steps (64-env maze) equals "
        f"{ROLLOUT_STEPS} act + observe steps, info ({', '.join(sorted(info_r))}) included")

    rows = [frame_row("joint maze,miner", launches, err, f_ms, fp_ms, fb_ms, fb_by)]
    rows.append({
        "name": "render_suffix",
        "path": "joint maze,miner",
        "route": "cuda",
        "source": "procgen_tpu_torch/csrc/render_suffix.cu",
        "replaces": "procgen_tpu/render/pallas_kernel.py:1136",
        "launches": launches["render_suffix"],
        "max_abs_err": err,
        "ms": s_ms,
        "plain_ms": sp_ms,
        "bound_ms": sb_ms,
        "bound_by": sb_by,
        "library_ms": None,
    })
    return rows


def torch_ops(fn):
    """The torch operations ``fn()`` dispatches: a count, not a time."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as c:
        fn()
    return c.n


RESET_CHUNK = 64  # a replenish chunk


def reset_ms(carry, name, torch, game=None):
    """Milliseconds of one ``env_reset`` of a replenish chunk's envs, fenced
    by synchronises (the mean of two calls after one unmeasured)."""
    from procgen_tpu_torch.core import lifecycle
    from procgen_tpu_torch.parallel import vec

    game = _game(name, 0) if game is None else game
    chunk = vec._tree_gather(carry.states, torch.arange(
        RESET_CHUNK, device=carry.valid.device))
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lifecycle.env_reset(game, chunk)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sum(times[1:]) / 2


def step_split(carry, actions, name, torch, game=None):
    """Per-layer milliseconds per step over ``len(actions)`` steps, each
    layer fenced by a synchronise: step logic (``env_step`` alone), pool
    (the rest of the pooled step: splice, in-step resets, replenish),
    frame prep, the kernel, the overlay pass.  Also the torch operations
    of one ``env_step``, one frame prep and one reset of a replenish
    chunk, since the host's dispatch of them bounds the step."""
    from procgen_tpu_torch.core import lifecycle
    from procgen_tpu_torch.parallel import vec
    from procgen_tpu_torch.render import render_kernel as rk
    from procgen_tpu_torch.render.renderer import post

    game = _game(name, 0) if game is None else game
    k = max(1, min(carry.valid.shape[0], 64))
    acc = {"logic": 0.0, "step": 0.0, "prep": 0.0, "kernel": 0.0, "post": 0.0}
    plan = rk.get_plan(game)
    dev = carry.valid.device
    saved = dict(rk.LAUNCHES)

    def lap(key, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        acc[key] += t1 - t0
        return t1

    torch.cuda.synchronize()
    for a in actions:
        t = time.perf_counter()
        lifecycle.env_step(game, carry.states, a)
        t = lap("logic", t)
        carry = vec.step_pool(game, carry, a, k)
        t = lap("step", t)
        if plan.static:
            ent_f, ent_i, decor = rk.prep_suffix(plan, carry.states)
            t = lap("prep", t)
            out = rk.render_suffix(carry.states.frame.contiguous(), ent_f, ent_i,
                                   plan.atlas(dev), len(plan.z_levels), decor)
        else:
            x = rk.prep_frame(plan, carry.states)
            t = lap("prep", t)
            out = rk.render_frame(x)
        t = lap("kernel", t)
        post(game, carry.states, out.to(torch.int32), 64).to(torch.uint8)
        lap("post", t)
    chunk = vec._tree_gather(carry.states, torch.arange(k, device=dev))
    ops = {
        "env_step": torch_ops(lambda: lifecycle.env_step(game, carry.states, actions[0])),
        "frame prep": torch_ops(lambda: rk.prep_suffix(plan, carry.states) if plan.static
                                else rk.prep_frame(plan, carry.states)),
        f"env_reset of {k} envs": torch_ops(lambda: lifecycle.env_reset(game, chunk)),
    }
    rk.LAUNCHES.update(saved)
    n = len(actions)
    ms = {k_: v * 1e3 / n for k_, v in acc.items()}
    return {
        "step logic": ms["logic"],
        "pool+replenish": ms["step"] - ms["logic"],
        "render prep": ms["prep"],
        "render kernel": ms["kernel"],
        "render post": ms["post"],
    }, ops


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
