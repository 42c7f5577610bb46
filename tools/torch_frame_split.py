"""Where a frame kernel's time goes: time the port's frame kernels with one
part cut out at a time, on the main paths' states, on one CUDA card.

    python3 tools/torch_frame_split.py [--old DIR] [--only GAME,GAME,...]

Builds copies of ``procgen_tpu_torch/csrc/`` into ``build/frame_split/``,
each with one part removed by a text edit (the kernels themselves carry no
switch), loads each copy as the port's kernel library and times
``render_suffix`` and ``render_frame`` on 4096 envs after 50 random steps:
maze, plunder, dodgeball and bossfight (the suffix), miner, coinrun and
climber under both cameras, fruitbot easy and hard and starpilot (the
whole frame); ``--only`` keeps the games it names.  Each build runs 200
launches per instance, the builds in turns, forward then backward; the
whole builds are held byte for byte against the plain versions.  With
``--old DIR``, also the kernels in DIR of the earlier design that walked
every live slot at every pixel, cut the same way (DIR from ``git archive
6eefe4e procgen_tpu_torch/csrc | tar -x -C build/old``).  Last, bare copies of a
frame batch (one byte a thread and access, and 16 bytes) for the floor of
the frame's bytes.  Prints one line per instance: ms per launch of each
build.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N = 4096
OUT = os.path.join(ROOT, "build", "frame_split")
T0 = time.perf_counter()

# (file, text, replacement) cuts of the current design (sprite.cuh's plan)
NOW = {
    "no_walk": [("sprite.cuh", "for (int w = 0; w < words; ++w) {",
                 "for (int w = 0; w < 0; ++w) {")],
    "no_plan": [("sprite.cuh", "for (int k0 = 0; k0 < total; k0 += 32) {",
                 "for (int k0 = 0; k0 < 0; k0 += 32) {"),
                ("sprite.cuh", "idx < n * 2 * RES;", "idx < 0;")],
    "no_bg": [("render_frame.cu", "    if constexpr (BG != BG_NONE) {\n      const int r_bg",
               "    if constexpr (false) {\n      const int r_bg")],
    "no_grid": [("render_frame.cu", "const bool inside = c_cell >= 0 && r_cell >= 0;",
                 "const bool inside = false;")],
}
NOW["io_only"] = NOW["no_plan"] + NOW["no_bg"] + NOW["no_grid"] + [
    ("sprite.cuh", "k < cap * EF_N;", "k < 0;"), ("sprite.cuh", "k < cap * EI_N;", "k < 0;"),
    ("render_frame.cu", "k < NC2; k += THREADS) tab[k]", "k < 0; k += THREADS) tab[k]")]
# the same cuts of the earlier design (paint_slots at every pixel)
OLD = {
    "no_slots": [("sprite.cuh", "for (int i = 0; i < count; ++i) {",
                  "for (int i = 0; i < 0; ++i) {")],
    "no_bg": [("render_frame.cu", "    if constexpr (BG != BG_NONE) {\n",
               "    if constexpr (false) {\n")],
    "no_grid": [("render_frame.cu",
                 "const bool inside = in_c && (cyx >= 0.f) && (cyx < (float)GS);",
                 "const bool inside = false;")],
}
OLD["io_only"] = OLD["no_slots"] + OLD["no_bg"] + OLD["no_grid"] + [
    ("sprite.cuh", "k < cap * EF_N;", "k < 0;"), ("sprite.cuh", "k < cap * EI_N;", "k < 0;"),
    ("render_frame.cu", "k < NC2; k += THREADS) tab[k]", "k < 0; k += THREADS) tab[k]")]

BARE = r'''
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void k_bytes(const uint8_t* b, uint8_t* o) {
  const int64_t px = (((int64_t)blockIdx.x * 64 + blockIdx.y * 4 + threadIdx.x / 64) * 64 +
                      threadIdx.x % 64) * 3;
  for (int c = 0; c < 3; ++c) o[px + c] = b[px + c] + 1;
}
__global__ void k_vec(const uint4* b, uint4* o) {
  for (int k = threadIdx.x; k < 768; k += blockDim.x) {
    uint4 v = b[(int64_t)blockIdx.x * 768 + k];
    v.x += 1;
    o[(int64_t)blockIdx.x * 768 + k] = v;
  }
}
extern "C" int bare(int vec, const void* b, void* o, int n, cudaStream_t s) {
  if (vec) k_vec<<<n, 256, 0, s>>>((const uint4*)b, (uint4*)o);
  else k_bytes<<<dim3(n, 16), 256, 0, s>>>((const uint8_t*)b, (uint8_t*)o);
  return (int)cudaGetLastError();
}
'''


def log(*a):
    print(f"[+{time.perf_counter() - T0:.0f}s]", *a, flush=True)


def build(builds):
    """builds: {name: (csrc dir, cuts)} -> {name: loaded library}."""
    from procgen_tpu_torch import kernels

    nvcc = kernels.nvcc_path()
    shutil.rmtree(OUT, ignore_errors=True)
    jobs = []
    for name, (src, cuts) in builds.items():
        d = os.path.join(OUT, name.replace(":", "_"))
        shutil.copytree(src, d)
        for fname, old, new in cuts:
            path = os.path.join(d, fname)
            with open(path) as f:
                text = f.read()
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the cut {old!r} does not match {fname} once")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        so = os.path.join(d, "lib.so")
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", so,
               os.path.join(d, "render_frame.cu"), os.path.join(d, "render_suffix.cu")]
        jobs.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    bare_dir = os.path.join(OUT, "bare")
    os.makedirs(bare_dir)
    with open(os.path.join(bare_dir, "bare.cu"), "w") as f:
        f.write(BARE)
    bare_so = os.path.join(bare_dir, "lib.so")
    jobs.append(("bare", bare_so, subprocess.Popen(
        [nvcc, *kernels.ARCH, "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", bare_so,
         os.path.join(bare_dir, "bare.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)))
    libs = {}
    for name, so, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        lib = ctypes.CDLL(so)
        if name == "bare":
            lib.bare.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_void_p]
        else:
            for ep in ("render_suffix", "render_frame"):
                getattr(lib, ep).argtypes = kernels.ENTRY_POINTS[ep]
        libs[name] = lib
    return libs


def cuda_ms(fn, torch, iters=200):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def cases(np, torch, only=None):
    """(label, kernel call, plain call) of each instance on its states;
    ``only``: the games to keep (None: all)."""
    from procgen_tpu_torch.core import lifecycle
    from procgen_tpu_torch.core.constants import INT32_MAX
    from procgen_tpu_torch.core.options import GameOptions
    from procgen_tpu_torch.entry import make_env_fns
    from procgen_tpu_torch.games.registry import make_game
    from procgen_tpu_torch.render import render_kernel as rk

    dev = torch.device("cuda")

    def plan_of(name, mode=0, centred=False):
        game = make_game(name, GameOptions(distribution_mode=mode, center_agent=centred))
        game.level_seed_low, game.level_seed_high = 0, INT32_MAX
        return rk.get_plan(game)

    def states(name):
        init, step, seeds = make_env_fns(N, name, device=dev)
        carry = init(seeds)
        rng = np.random.RandomState(1)
        for _ in range(50):
            carry, *_ = step(carry, torch.as_tensor(rng.randint(0, 15, size=N), device=dev))
        return carry.states, seeds

    def wanted(name):
        return only is None or name in only

    out = []
    for name in ("maze", "plunder", "dodgeball", "bossfight"):
        if not wanted(name):
            continue
        s, _ = states(name)
        plan = plan_of(name)
        ent_f, ent_i, decor = rk.prep_suffix(plan, s)
        args = (s.frame.contiguous(), ent_f, ent_i, plan.atlas(dev), len(plan.z_levels), decor)
        out.append((f"{name} render_suffix", lambda a=args: rk.render_suffix(*a),
                    lambda a=args: rk.render_suffix_reference(*a)))
    for name, cams in (("miner", (False,)), ("coinrun", (False, True)),
                       ("fruitbot", (False,)), ("starpilot", (False,)),
                       ("climber", (False, True))):
        if not wanted(name):
            continue
        s, seeds = states(name)
        for centred in cams:
            x = rk.prep_frame(plan_of(name, 0, centred), s)
            out.append((f"{name}{' centred' if centred else ''} render_frame",
                        lambda x=x: rk.render_frame(x), lambda x=x: rk.render_frame_reference(x)))
    if not wanted("fruitbot"):
        return out
    hard = plan_of("fruitbot", 1)
    s = lifecycle.env_reset(hard.game, lifecycle.initial_state(hard.game, seeds))
    rng = np.random.RandomState(1)
    for _ in range(20):
        s, _ = lifecycle.env_step(hard.game, s, torch.as_tensor(
            rng.choice([1, 4, 7, 9], size=N), device=dev))
    x = rk.prep_frame(hard, s)
    out.append(("fruitbot hard render_frame", lambda: rk.render_frame(x),
                lambda: rk.render_frame_reference(x)))
    return out


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_frame_split: no CUDA device", file=sys.stderr)
        return 2
    from procgen_tpu_torch import kernels

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    now = os.path.join(ROOT, "procgen_tpu_torch", "csrc")
    builds = {"now:whole": (now, [])}
    builds.update({f"now:{k}": (now, v) for k, v in NOW.items()})
    if "--old" in sys.argv:
        old = os.path.abspath(sys.argv[sys.argv.index("--old") + 1])
        builds["old:whole"] = (old, [])
        builds.update({f"old:{k}": (old, v) for k, v in OLD.items()})
    libs = build(builds)
    log(f"built {len(builds)} kernel libraries on {card}")
    names = list(builds)
    only = (set(sys.argv[sys.argv.index("--only") + 1].split(","))
            if "--only" in sys.argv else None)
    for label, fn, ref in cases(np, torch, only):
        want = ref()
        ms = {k: [] for k in names}
        for order in (names, names[::-1]):
            for k in order:
                kernels._LIB = libs[k]
                ms[k].append(cuda_ms(fn, torch))
        errs = {}
        for k in names:
            if k.endswith(":whole"):
                kernels._LIB = libs[k]
                got = fn()
                torch.cuda.synchronize()
                errs[k] = int((got.int() - want.int()).abs().max())
        log(label, "; ".join(f"{k} {sum(v) / 2:.4f} ({v[0]:.4f}, {v[1]:.4f})"
                             for k, v in ms.items()), f"| max_abs_err {errs}")
    kernels._LIB = None
    b = torch.zeros((N, 64, 64, 3), dtype=torch.uint8, device="cuda")
    o = torch.empty_like(b)
    stream = torch.cuda.current_stream().cuda_stream
    for vec, what in ((0, "one byte a thread and access, grid (N, 16)"),
                      (1, "16 bytes a thread and access, a block an env")):
        t = cuda_ms(lambda: libs["bare"].bare(vec, b.data_ptr(), o.data_ptr(), N, stream), torch)
        log(f"bare copy of {N} frames, {what}: {t:.4f} ms")
    log(f"on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
