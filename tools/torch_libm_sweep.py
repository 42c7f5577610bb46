"""Sweep the port's glibc trig (procgen_tpu_torch/core/libm.py) against the
JAX package's, on the CPU.

    python tools/torch_libm_sweep.py [--exhaustive] [--variant] [--large]
                                     [--pow] [--spawners]

Prints one line per count:

* the sample: 4,000,000 of starpilot's reset angles, ``(rand01 - 0.5) *
  pi/2`` from random words (procgen_tpu/games/starpilot.py:318-334), and
  2,000,000 ``atan2`` pairs uniform in [-16, 16]; for each of the port's
  ``libm``, ``torch.cos``/``sin``/``atan2`` and the f64 function rounded
  to f32, the number of results that differ from ``jax.jit(jnp.cos /
  sin / arctan2)`` in any bit;
* with ``--exhaustive``: every distinct reset angle (the angles of the
  83,886,081 distinct values ``rand01`` takes), the port's ``cosf`` and
  ``sinf`` against JAX's (about a minute and 2 GB);
* with ``--large``: the arguments of glibc's ``reduce_large``, 4,000,000
  floats log-uniform from 120 to 2^127 of both signs and the first
  1,048,576 floats from 120 on:
  the port's ``cosf`` and ``sinf`` against JAX's, and against
  ``libm.so.6`` through ctypes on the first 200,000 of the sample;
* with ``--pow``: bigfish's fish radius, ``f32(1.75 * pow(r, 1.4) + 0.25)``
  in double (bigfish.cpp:85), at every distinct ``rand01`` value ``r``:
  the port's ``games/bigfish.fish_radius`` (torch's f64 ``pow``) against
  glibc's ``pow`` from libm.so.6 through ctypes, in worker processes (about
  a minute on 8 cores); also how many of the f64 powers themselves differ;
* with ``--spawners``: starpilot's spawner velocities, ``f32(cos(theta) *
  v)`` and ``f32(sin(theta) * v)`` with C's double ``sin``/``cos``, at the
  heading ``theta = f32((r - .5) * 2 * PI / 4)`` of every distinct
  ``rand01`` value and every speed ``v`` a spawner takes in any mode: the
  port's ``core/libm.sincos_times`` against libm.so.6's ``sin`` and
  ``cos`` through ctypes;
* with ``--variant`` (needs ``gcc``): which build of glibc's code the
  machine's libm runs.  A C transcription of ``sinf``/``cosf``
  (sysdeps/ieee754/flt-32/s_sinf.c, s_cosf.c, sincosf.h) and of fdlibm's
  ``atanf`` is compiled twice, with every ``a * b + c`` fused
  (``-mfma -ffp-contract=fast``, glibc's ``-mfma`` ifunc build) and with
  none (``-ffp-contract=off``), and each build is held against libm on
  every float: below 120 for ``sinf`` and ``cosf``, all 2^32 for
  ``atanf`` (a minute or two).

The JAX side runs in this process; its trig is glibc's ``cosf``, ``sinf``
and ``atan2f`` (tests/test_torch_libm.py holds both against libm.so.6).
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

F32 = np.float32


def reset_angles(r01):
    return ((r01.astype(F32) - F32(0.5)) * F32(np.pi / 2)).astype(F32)


def distinct_rand01():
    """Every value ``f32(word) * 2^-32`` takes, ascending (numpy f32)."""
    from tools.draw_domains import distinct_rand01 as values

    return values().numpy()


VARIANT_C = r"""
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>
static const double SIGN[4] = {1.0, -1.0, -1.0, 1.0};
static const double HPI_INV = 0x1.45F306DC9C883p+23, HPI = 0x1.921FB54442D18p0;
static const double C[2][5] = {
  {0x1p0, -0x1.ffffffd0c621cp-2, 0x1.55553e1068f19p-5, -0x1.6c087e89a359dp-10,
   0x1.99343027bf8c3p-16},
  {-0x1p0, 0x1.ffffffd0c621cp-2, -0x1.55553e1068f19p-5, 0x1.6c087e89a359dp-10,
   -0x1.99343027bf8c3p-16}};
static const double S1 = -0x1.555545995a603p-3, S2 = 0x1.1107605230bc4p-7,
                    S3 = -0x1.994eb3774cf24p-13;
static uint32_t top12(float y) { uint32_t u; memcpy(&u, &y, 4); return (u >> 20) & 0x7ff; }
static float poly(double x, double x2, int t, int n) {
  if ((n & 1) == 0) {
    double x3 = x * x2, s1 = S2 + x2 * S3, x7 = x3 * x2, s = x + x3 * S1;
    return s + x7 * s1;
  }
  double x4 = x2 * x2, c2 = C[t][3] + x2 * C[t][4], c1 = C[t][0] + x2 * C[t][1];
  double x6 = x4 * x2, c = c1 + x4 * C[t][2];
  return c + x6 * c2;
}
static float my_sincos(float y, int is_cos) {
  double x = y;
  if (top12(y) < 0x3f4) {
    if (top12(y) < 0x398) return is_cos ? 1.0f : y;
    return poly(x, x * x, 0, is_cos);
  }
  double r = x * HPI_INV;
  int n = ((int32_t)r + 0x800000) >> 24;
  x = x - n * HPI;
  return poly(x * SIGN[n & 3], x * x, (n & 2) ? 1 : 0, n ^ is_cos);
}
static const float atanhi[] = {4.6364760399e-01f, 7.8539812565e-01f,
                               9.8279368877e-01f, 1.5707962513e+00f};
static const float atanlo[] = {5.0121582440e-09f, 3.7748947079e-08f,
                               3.4473217170e-08f, 7.5497894159e-08f};
static const float aT[] = {
  3.3333334327e-01f, -2.0000000298e-01f, 1.4285714924e-01f, -1.1111110449e-01f,
  9.0908870101e-02f, -7.6918758452e-02f, 6.6610731184e-02f, -5.8335702866e-02f,
  4.9768779427e-02f, -3.6531571299e-02f, 1.6285819933e-02f};
static float my_atanf(float x) {
  float w, s1, s2, z; int32_t ix, hx, id;
  memcpy(&hx, &x, 4); ix = hx & 0x7fffffff;
  if (ix >= 0x4c000000) {
    if (ix > 0x7f800000) return x + x;
    return hx > 0 ? atanhi[3] + atanlo[3] : -atanhi[3] - atanlo[3];
  }
  if (ix < 0x3ee00000) { if (ix < 0x31000000) return x; id = -1; }
  else {
    x = fabsf(x);
    if (ix < 0x3f980000) {
      if (ix < 0x3f300000) { id = 0; x = (2.0f * x - 1.0f) / (2.0f + x); }
      else { id = 1; x = (x - 1.0f) / (x + 1.0f); }
    } else {
      if (ix < 0x401c0000) { id = 2; x = (x - 1.5f) / (1.0f + 1.5f * x); }
      else { id = 3; x = -1.0f / x; }
    }
  }
  z = x * x; w = z * z;
  s1 = z * (aT[0] + w * (aT[2] + w * (aT[4] + w * (aT[6] + w * (aT[8] + w * aT[10])))));
  s2 = w * (aT[1] + w * (aT[3] + w * (aT[5] + w * (aT[7] + w * aT[9]))));
  if (id < 0) return x - x * (s1 + s2);
  z = atanhi[id] - ((x * (s1 + s2) - atanlo[id]) - x);
  return hx < 0 ? -z : z;
}
static int differ(float a, float b) {
  return memcmp(&a, &b, 4) != 0 && !(isnan(a) && isnan(b));
}
int main(void) {
  long below = 0, d_sin = 0, d_cos = 0, d_atan = 0;
  for (uint64_t u = 0; u < 0x100000000ull; ++u) {
    uint32_t v = (uint32_t)u; float y; memcpy(&y, &v, 4);
    d_atan += differ(atanf(y), my_atanf(y));
    if (!(fabsf(y) < 120.0f)) continue;
    ++below;
    d_sin += differ(sinf(y), my_sincos(y, 0));
    d_cos += differ(cosf(y), my_sincos(y, 1));
  }
  printf("%ld floats below 120: sinf differs on %ld, cosf on %ld; "
         "all 2^32 floats: atanf differs on %ld\n", below, d_sin, d_cos, d_atan);
  return 0;
}
"""


def variant():
    """Build the C transcription fused and unfused, run both against libm."""
    import subprocess
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "variant.c")
        with open(src, "w") as f:
            f.write(VARIANT_C)
        builds = {"fused (-mfma -mavx2 -ffp-contract=fast)":
                  ["-mfma", "-mavx2", "-ffp-contract=fast"],
                  "unfused (-ffp-contract=off)": ["-ffp-contract=off"]}
        procs = {}
        for name, flags in builds.items():
            exe = os.path.join(tmp, str(len(procs)))
            subprocess.run(["gcc", "-O2", *flags, src, "-o", exe, "-lm"], check=True)
            procs[name] = subprocess.Popen([exe], stdout=subprocess.PIPE, text=True)
        for name, p in procs.items():
            print(f"C transcription, {name}: {p.communicate()[0].strip()}", flush=True)


def large(libm, jcos, jsin, diff, torch, jnp):
    """The ``--large`` sweep: the port against JAX and against libm.so.6."""
    import ctypes
    import ctypes.util

    t0 = time.time()
    rng = np.random.RandomState(1)
    e = rng.uniform(np.log2(120.0), 127.99, 4_000_000)
    sample = (np.exp2(e) * rng.choice([-1.0, 1.0], e.size)).astype(F32)
    first = (np.arange(1 << 20, dtype=np.uint32) + np.float32(120.0).view(np.uint32)).view(F32)
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for name, port, ref in (("cos", libm.cosf, jcos), ("sin", libm.sinf, jsin)):
        fn = getattr(lib, name + "f")
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
        for what, xs in (("log-uniform from 120 to 2^127", sample),
                         ("the first from 120 on", first)):
            got = port(torch.from_numpy(xs)).numpy()
            print(f"{name}, {len(xs)} floats {what}: port differs from JAX on "
                  f"{diff(got, np.asarray(ref(jnp.asarray(xs))))}, NaN on "
                  f"{int(np.isnan(got).sum())}", flush=True)
        sub = sample[:200_000]
        want = np.fromiter((fn(v) for v in sub.tolist()), F32, len(sub))
        print(f"{name}, {len(sub)} of them: port differs from libm.so.6 on "
              f"{diff(port(torch.from_numpy(sub)).numpy(), want)}", flush=True)
    print(f"large sweep: {time.time() - t0:.1f} s", flush=True)


def _glibc_chunk(job):
    """glibc's double ``pow(x, 1.4)``, or ``sin``/``cos``, of the floats
    ``xs`` through ctypes (one worker process's share)."""
    import ctypes

    name, xs = job
    lib = ctypes.CDLL("libm.so.6")
    if name == "pow":
        fn = lib.pow
        fn.restype, fn.argtypes = ctypes.c_double, [ctypes.c_double, ctypes.c_double]
        return np.fromiter((fn(v, 1.4) for v in xs.tolist()), np.float64, len(xs))
    fn = getattr(lib, name)
    fn.restype, fn.argtypes = ctypes.c_double, [ctypes.c_double]
    return np.fromiter((fn(v) for v in xs.tolist()), np.float64, len(xs))


def _glibc(name, xs, pool, parts=64):
    return np.concatenate(pool.map(_glibc_chunk, [(name, c) for c in np.array_split(xs, parts)]))


def pow_sweep(torch, pool):
    """The ``--pow`` sweep."""
    from procgen_tpu_torch.games.bigfish import fish_radius

    t0 = time.time()
    r = distinct_rand01()
    p = _glibc("pow", r.astype(np.float64), pool)
    want = (1.75 * p + 0.25).astype(F32)
    tr = torch.from_numpy(r)
    got = fish_radius(tr).numpy()
    tp = torch.pow(tr.to(torch.float64), 1.4).numpy()
    print(f"pow: {len(r)} distinct rand01 values: the port's fish radius differs "
          f"from glibc's on {int((got.view(np.uint32) != want.view(np.uint32)).sum())}; "
          f"torch's f64 pow differs from glibc's pow itself on "
          f"{int((tp != p).sum())} ({time.time() - t0:.1f} s)", flush=True)


def spawner_sweep(torch, pool):
    """The ``--spawners`` sweep."""
    from procgen_tpu_torch.core.libm import sincos_times
    from tools.draw_domains import spawner_speeds

    t0 = time.time()
    r = distinct_rand01()
    theta = np.unique(((r.astype(np.float64) - 0.5) * (float(F32(np.pi)) / 2)).astype(F32))
    th64 = theta.astype(np.float64)
    s64, c64 = _glibc("sin", th64, pool), _glibc("cos", th64, pool)
    tt = torch.from_numpy(theta)
    bad = {"sin": 0, "cos": 0}
    speeds = spawner_speeds()
    for v in speeds:
        got_s, got_c = sincos_times(tt, torch.full_like(tt, v))
        for name, got, ref in (("sin", got_s, s64), ("cos", got_c, c64)):
            want = (ref * v).astype(F32)
            bad[name] += int((got.numpy().view(np.uint32) != want.view(np.uint32)).sum())
    print(f"spawners: {len(theta)} distinct headings x {len(speeds)} speeds: the "
          f"port's sin products differ from glibc's on {bad['sin']}, cos products "
          f"on {bad['cos']} ({time.time() - t0:.1f} s)", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--exhaustive", action="store_true")
    ap.add_argument("--variant", action="store_true")
    ap.add_argument("--large", action="store_true")
    ap.add_argument("--pow", action="store_true")
    ap.add_argument("--spawners", action="store_true")
    args = ap.parse_args()
    if args.variant:
        variant()
    if args.pow or args.spawners:
        import multiprocessing

        import torch

        with multiprocessing.get_context("fork").Pool() as pool:
            if args.pow:
                pow_sweep(torch, pool)
            if args.spawners:
                spawner_sweep(torch, pool)

    import jax
    import jax.numpy as jnp
    import torch

    from procgen_tpu_torch.core import libm

    jax.config.update("jax_platforms", "cpu")
    jcos, jsin, jatan2 = jax.jit(jnp.cos), jax.jit(jnp.sin), jax.jit(jnp.arctan2)

    def diff(a, b):
        a, b = np.asarray(a, F32), np.asarray(b, F32)
        return int((a.view(np.uint32) != b.view(np.uint32)).sum())

    rng = np.random.RandomState(0)
    words = rng.randint(0, 2**32, 4_000_000, dtype=np.uint64)
    th = reset_angles(words.astype(F32) * F32(2.0**-32))
    tt = torch.from_numpy(th)
    for name, port, ref, lib, f64 in (
            ("cos", libm.cosf, jcos, torch.cos, np.cos),
            ("sin", libm.sinf, jsin, torch.sin, np.sin)):
        want = np.asarray(ref(jnp.asarray(th)))
        print(f"{name}, {len(th)} reset angles: differ from JAX: port libm "
              f"{diff(port(tt).numpy(), want)}, torch {diff(lib(tt).numpy(), want)}, "
              f"f64 rounded to f32 {diff(f64(th.astype(np.float64)).astype(F32), want)}",
              flush=True)
    ys, xs = (rng.uniform(-16, 16, 2_000_000).astype(F32) for _ in range(2))
    want = np.asarray(jatan2(jnp.asarray(ys), jnp.asarray(xs)))
    ty, tx = torch.from_numpy(ys), torch.from_numpy(xs)
    print(f"atan2, {len(ys)} pairs in [-16, 16]: differ from JAX: port libm "
          f"{diff(libm.atan2f(ty, tx).numpy(), want)}, torch "
          f"{diff(torch.atan2(ty, tx).numpy(), want)}, f64 rounded to f32 "
          f"{diff(np.arctan2(ys.astype(np.float64), xs.astype(np.float64)).astype(F32), want)}",
          flush=True)

    if args.large:
        large(libm, jcos, jsin, diff, torch, jnp)

    if args.exhaustive:
        t0 = time.time()
        angles = np.unique(reset_angles(distinct_rand01()))
        bad = {"cos": 0, "sin": 0}
        chunk = 1 << 22
        for i in range(0, len(angles), chunk):
            a = angles[i:i + chunk]
            ta = torch.from_numpy(a)
            bad["cos"] += diff(libm.cosf(ta).numpy(), np.asarray(jcos(jnp.asarray(a))))
            bad["sin"] += diff(libm.sinf(ta).numpy(), np.asarray(jsin(jnp.asarray(a))))
        print(f"exhaustive: {len(angles)} distinct reset angles, port differs from "
              f"JAX in cos {bad['cos']}, sin {bad['sin']} ({time.time() - t0:.1f} s)",
              flush=True)


if __name__ == "__main__":
    main()
