"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one line of output each (a phase that fails raises, and the
process exits non-zero):

1. device   — CUDA present; torch, CUDA, nvcc versions; card name and
              power limit (nvidia-smi).
2. build    — nvcc builds procgen_tpu_torch/csrc/*.cu; seconds, ptxas.
3. kernel   — the frame kernel against its plain torch version, byte for
              byte: on the prep of 4096 maze states after 50 random steps,
              and on a made-up batch (fallback slots, alpha < 1, tall and
              clipped rects, flips, transposed rows, tiling, dead slots).
4. slice    — ``entry.make_env_fns(4096, "maze", device="cuda")``: init,
              100 warm-up steps, 300 timed steps (the bench.py protocol);
              one kernel launch per step; env-steps/s; a per-layer split
              of the step; the kernel's time against the plain version's.
5. check    — a 64-env ``ProcgenGym3Env`` for 50 steps on the card and on
              the CPU, bit-equal; the maze_easy reference recording
              replayed exactly on the card.
6. result   — a JSON line of the kernels, the card line, and the last line
              ``{"ok": true, "device": {...}}``.

It needs one card and imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

NUM_ENVS = 4096
WARM_STEPS = 100
TIMED_STEPS = 300


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


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


def main():
    import numpy as np
    import torch

    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from procgen_tpu_torch import kernels

    nvcc_ver = subprocess.run(
        [kernels.nvcc_path(), "--version"], capture_output=True, text=True,
        check=True,
    ).stdout.strip().splitlines()[-1]
    card = card_line()
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{nvcc_ver} | {card} | count {torch.cuda.device_count()}")
    dev = torch.device("cuda")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    kernels.load()
    info = kernels.BUILD_INFO
    log("build", f"nvcc {info['seconds']:.2f}s (load {time.perf_counter() - t0:.2f}s) "
        f"{' | '.join(info.get('ptxas', []))}")

    from procgen_tpu_torch.core.constants import EASY_MODE, INT32_MAX
    from procgen_tpu_torch.core.options import GameOptions
    from procgen_tpu_torch.entry import make_env_fns
    from procgen_tpu_torch.games.registry import make_game
    from procgen_tpu_torch.render import render_kernel as rk

    # the entry point's game, configured the same way, for the direct
    # kernel calls and the per-layer split
    maze = make_game("maze", GameOptions(distribution_mode=EASY_MODE))
    maze.level_seed_low, maze.level_seed_high = 0, INT32_MAX

    # -- 3. kernel vs plain version ---------------------------------------
    init, step, seeds = make_env_fns(NUM_ENVS, "maze", device=dev)
    carry = init(seeds)
    rng = np.random.RandomState(1)
    for _ in range(50):
        acts = torch.as_tensor(rng.randint(0, 15, size=NUM_ENVS), device=dev)
        carry, obs, rew, done = step(carry, acts)
    plan = rk.get_plan(maze)
    atlas = plan.atlas(dev)
    ent_f, ent_i = rk.prep(plan, carry.states)
    base = carry.states.frame.contiguous()
    nz = len(plan.z_levels)
    got = rk.render_suffix(base, ent_f, ent_i, atlas, nz)
    want = rk.render_suffix_reference(base, ent_f, ent_i, atlas, nz)
    torch.cuda.synchronize()
    err_real = int((got.int() - want.int()).abs().max())
    live = int(ent_i[..., rk.EI_LIVE].sum())
    if err_real != 0:
        raise AssertionError(f"kernel != plain on maze states (max err {err_real})")
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
        raise AssertionError(f"kernel != plain on made-up slots (max err {err_syn})")
    changed = float((got_s != sbase).any(dim=-1).float().mean())
    log("kernel", f"byte-equal: {NUM_ENVS} maze states ({live} live slots) and "
        f"{NUM_ENVS}x8 made-up slots ({changed:.3f} of pixels painted); "
        f"max_abs_err {max(err_real, err_syn)}")
    del carry, obs

    # -- 4. the slice ------------------------------------------------------
    carry = init(seeds)
    torch.cuda.synchronize()
    total = WARM_STEPS + TIMED_STEPS
    actions = torch.as_tensor(
        np.random.RandomState(0).randint(0, 15, size=(total, NUM_ENVS)),
        dtype=torch.int32, device=dev,
    )
    rk.LAUNCHES = 0
    for t in range(WARM_STEPS):
        carry, obs, rew, done = step(carry, actions[t])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(WARM_STEPS, total):
        carry, obs, rew, done = step(carry, actions[t])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = rk.LAUNCHES
    if launches != total:
        raise AssertionError(f"{launches} kernel launches in {total} steps")
    if obs.dtype != torch.uint8 or tuple(obs.shape) != (NUM_ENVS, 64, 64, 3) \
            or not obs.is_cuda:
        raise AssertionError(f"bad obs {obs.dtype} {tuple(obs.shape)} {obs.device}")
    if not (torch.isfinite(rew).all() and rew.shape == (NUM_ENVS,)):
        raise AssertionError("bad rewards")
    rate = TIMED_STEPS * NUM_ENVS / dt
    log("slice", f"{rate:.1f} env-steps/s ({dt / TIMED_STEPS * 1e3:.2f} ms/step, "
        f"{NUM_ENVS} envs, {TIMED_STEPS} timed steps after {WARM_STEPS}) "
        f"on {card}; launches {launches} in {total} steps")

    split = _step_split(maze, carry, actions[:100], dev)
    log("slice", "step split (synchronised, ms/step): " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()))

    ent_f, ent_i = rk.prep(plan, carry.states)
    base = carry.states.frame.contiguous()

    def kern():
        rk.render_suffix(base, ent_f, ent_i, atlas, nz)

    def plain():
        rk.render_suffix_reference(base, ent_f, ent_i, atlas, nz)

    saved = rk.LAUNCHES
    k1, p1, k2, p2 = cuda_ms(kern, 200), cuda_ms(plain, 20), cuda_ms(kern, 200), cuda_ms(plain, 20)
    rk.LAUNCHES = saved
    kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    gbps = 2 * NUM_ENVS * 64 * 64 * 3 / (kernel_ms * 1e-3) / 1e9
    log("slice", f"render_suffix at N={NUM_ENVS}: kernel {kernel_ms:.4f} ms "
        f"({k1:.4f}, {k2:.4f}), plain torch {plain_ms:.4f} ms ({p1:.4f}, {p2:.4f}); "
        f"frame bytes {gbps:.0f} GB/s on {card}")

    # -- 5. GPU vs CPU, and the reference recording -----------------------
    from procgen_tpu_torch import ProcgenGym3Env
    from procgen_tpu_torch.conformance import replay

    envs = {d: ProcgenGym3Env(num=64, env_name="maze", distribution_mode="easy",
                              rand_seed=0, device=d) for d in ("cuda", "cpu")}
    arng = np.random.RandomState(3)
    for t in range(50):
        a = arng.randint(0, 15, size=64).astype(np.int32)
        outs = {}
        for d, env in envs.items():
            env.act(a)
            rew_, obs_, first_ = env.observe()
            inf = env._vec._info_impl(env._vec.states)
            outs[d] = [obs_["rgb"], rew_, first_] + [
                v.cpu().numpy() for _, v in sorted(inf.items())]
        for x, y in zip(outs["cuda"], outs["cpu"]):
            if x.dtype != y.dtype or not np.array_equal(x, y):
                raise AssertionError(f"GPU and CPU runs differ at step {t}")
    rec = json.load(open(os.path.join(ROOT, "tests", "data", "conformance",
                                      "maze_easy.json")))
    res = replay(rec, device="cuda")
    if res["first_divergence"] is not None:
        raise AssertionError(f"maze_easy replay diverged: {res['first_divergence']}")
    log("check", "64 envs x 50 steps: GPU and CPU bit-equal (obs, rewards, "
        f"firsts, latents); maze_easy replay exact ({res['checked']} steps)")

    # -- 6. result -----------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "render_suffix",
        "route": "cuda",
        "source": "procgen_tpu_torch/csrc/render_suffix.cu",
        "replaces": "procgen_tpu/render/pallas_kernel.py:1136",
        "launches": launches,
        "max_abs_err": max(err_real, err_syn),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def _step_split(game, carry, actions, dev):
    """Per-layer milliseconds per step over ``len(actions)`` steps, each
    layer fenced by a synchronise: step logic (``env_step`` alone), pool
    (the rest of the pooled step: splice, in-step resets, replenish),
    frame prep, the kernel, the overlay pass."""
    import torch

    from procgen_tpu_torch.core import lifecycle
    from procgen_tpu_torch.parallel import vec
    from procgen_tpu_torch.render import render_kernel as rk
    from procgen_tpu_torch.render.renderer import post

    k = max(1, min(carry.valid.shape[0], 64))
    acc = {"logic": 0.0, "step": 0.0, "prep": 0.0, "kernel": 0.0, "post": 0.0}
    plan = rk.get_plan(game)
    atlas = plan.atlas(dev)
    nz = len(plan.z_levels)
    saved = rk.LAUNCHES

    def lap(name, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        acc[name] += t1 - t0
        return t1

    torch.cuda.synchronize()
    for a in actions:
        t = time.perf_counter()
        lifecycle.env_step(game, carry.states, a)
        t = lap("logic", t)
        carry = vec.step_pool(game, carry, a, k)
        t = lap("step", t)
        ent_f, ent_i = rk.prep(plan, carry.states)
        t = lap("prep", t)
        out = rk.render_suffix(carry.states.frame.contiguous(), ent_f, ent_i,
                               atlas, nz)
        t = lap("kernel", t)
        post(game, carry.states, out.to(torch.int32), 64).to(torch.uint8)
        lap("post", t)
    rk.LAUNCHES = saved
    n = len(actions)
    ms = {k_: v * 1e3 / n for k_, v in acc.items()}
    return {
        "step logic": ms["logic"],
        "pool+replenish": ms["step"] - ms["logic"],
        "render prep": ms["prep"],
        "render kernel": ms["kernel"],
        "render post": ms["post"],
    }


if __name__ == "__main__":
    sys.exit(main())
