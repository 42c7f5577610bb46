"""The port's ``core/libm.py`` against the JAX package's trig.

The JAX package's ``jnp.cos``, ``jnp.sin`` and ``jnp.arctan2`` on the CPU
are glibc's ``cosf``, ``sinf`` and ``atan2f`` (XLA calls them), which is
also what the C++ reference calls.  ``libm.cosf``, ``libm.sinf`` and
``libm.atan2f`` must equal both, bit for bit:

* on 1,048,576 of starpilot's reset angles, made from a numpy seed the
  way ``procgen_tpu/games/starpilot.py:318-334`` makes them,
  ``(rand01 - 0.5) * pi/2``, and on the angle of ``rand01 = 1.0`` (words
  from 2^32 - 128 up round to 1.0);
* on the edges of every binade below 120 (2^k and the float below it,
  both signs), the polynomial's edges (0.75, pi/4, 2^-12), +-0, and the
  player's fire angles 0 and pi;
* from 120 on (glibc's ``reduce_large``): 262,144 floats log-uniform from
  120 to 2^127 of both signs, the edges of every binade from 2^7 up, the
  largest float, and +-inf and NaN (NaN out);
* ``atan2f`` on 1,048,576 pairs (uniform in [-16, 16] and random bit
  patterns), the axes and signed zeros, ``x = 1``, infinities, NaN, and
  ratios beyond 2^60 and below 2^-60 on both sides.

The oracle is glibc itself (``libm.so.6`` through ctypes) and the JAX
package's jitted functions.  The exhaustive sweep of every distinct reset
angle is ``tools/torch_libm_sweep.py``.  Tolerance: zero.
"""

import ctypes
import ctypes.util
import inspect
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from procgen_tpu_torch.core import libm  # noqa: E402

M = 1 << 20
F32 = np.float32
HALF_PI = F32(np.pi / 2)


def _glibc():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for name in ("cosf", "sinf"):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    lib.atan2f.restype = ctypes.c_float
    lib.atan2f.argtypes = [ctypes.c_float, ctypes.c_float]
    return lib


LIB = _glibc()


def _oracle1(name, xs):
    fn = getattr(LIB, name)
    return np.fromiter((fn(v) for v in xs.tolist()), F32, len(xs))


def _oracle_atan2(ys, xs):
    fn = LIB.atan2f
    return np.fromiter((fn(a, b) for a, b in zip(ys.tolist(), xs.tolist())),
                       F32, len(xs))


def _same_bits(got, want):
    """Bit-equal, NaN for NaN; returns the indices that differ."""
    got, want = np.asarray(got, F32), np.asarray(want, F32)
    same = (got.view(np.uint32) == want.view(np.uint32)) | (np.isnan(got) & np.isnan(want))
    return np.flatnonzero(~same)


def _reset_angles():
    """The reset's angles for 2^20 words from a seed, the angle of
    rand01 = 1.0, the zero heading, and the player's fire angles."""
    words = np.random.RandomState(2024).randint(0, 2**32, M, dtype=np.uint64)
    words = np.concatenate([words, [2**32 - 1, 2**32 - 128, 2**32 - 129, 0]])
    r01 = words.astype(F32) * F32(2.0**-32)
    assert r01[-4] == r01[-3] == F32(1.0) and r01[-2] < F32(1.0)
    theta = (r01 - F32(0.5)) * HALF_PI
    return np.concatenate([theta, np.array([0.0, -0.0, np.pi, -np.pi], F32)])


def _edges():
    """2^k and the float below it for every binade below 120, both signs,
    and the polynomial's own edges."""
    ks = np.arange(-149, 7)
    tops = np.ldexp(np.ones_like(ks, dtype=np.float64), ks).astype(F32)
    below = np.nextafter(tops, F32(0))
    special = np.array([0.75, np.pi / 4, 2.0**-12, 119.99999, 64.0, np.pi], F32)
    around = np.concatenate([special, np.nextafter(special, F32(0)),
                             np.nextafter(special, F32(200))])
    xs = np.concatenate([tops, below, around, [0.0]]).astype(F32)
    xs = xs[np.abs(xs) < 120]
    return np.concatenate([xs, -xs])


def _pairs():
    rng = np.random.RandomState(7)
    half = M // 2
    uni = rng.uniform(-16, 16, (2, half)).astype(F32)
    bits = rng.randint(0, 2**32, (2, half), dtype=np.uint64).astype(np.uint32).view(F32)
    sp = np.array([0.0, -0.0, 1.0, -1.0, 3.0, -2.5, np.inf, -np.inf, np.nan,
                   1e-30, -1e30, 2.0**70, -(2.0**70), 2.0**-70, -(2.0**-70),
                   1e-45, -3.4e38], F32)
    ys, xs = np.meshgrid(sp, sp)
    return (np.concatenate([uni[0], bits[0], ys.ravel()]),
            np.concatenate([uni[1], bits[1], xs.ravel()]))


@pytest.fixture(scope="module")
def jax_trig():
    return (jax.jit(jnp.cos), jax.jit(jnp.sin), jax.jit(jnp.arctan2))


@pytest.mark.parametrize("inputs", ["reset_angles", "edges"])
@pytest.mark.parametrize("name", ["cosf", "sinf"])
def test_cos_sin_match_glibc_and_jax(name, inputs, jax_trig):
    xs = _reset_angles() if inputs == "reset_angles" else _edges()
    got = getattr(libm, name)(torch.from_numpy(xs)).numpy()
    jfn = jax_trig[0] if name == "cosf" else jax_trig[1]
    want = np.asarray(jfn(jnp.asarray(xs)))
    bad = _same_bits(got, want)
    assert bad.size == 0, (xs[bad[:5]], got[bad[:5]], want[bad[:5]])
    bad = _same_bits(got, _oracle1(name, xs))
    assert bad.size == 0, (xs[bad[:5]], got[bad[:5]])


def test_cos_sin_differ_from_torch():
    """The reason for the module: torch's own cos and sin part from glibc
    on a share of the reset angles."""
    xs = torch.from_numpy(_reset_angles()[:M // 4])
    for mine, theirs in ((libm.cosf, torch.cos), (libm.sinf, torch.sin)):
        assert (mine(xs) != theirs(xs)).any()


def _subnormal(v):
    v = np.abs(np.asarray(v, F32))
    return (v > 0) & (v < np.finfo(F32).tiny)


def test_atan2_matches_glibc_and_jax(jax_trig):
    """Against glibc everywhere; against the JAX package wherever no input
    and no result is subnormal: XLA's CPU runtime flushes subnormals to
    zero (a ratio beyond 2^126 gives them), glibc and the port do not."""
    ys, xs = _pairs()
    got = libm.atan2f(torch.from_numpy(ys), torch.from_numpy(xs)).numpy()
    bad = _same_bits(got, _oracle_atan2(ys, xs))
    assert bad.size == 0, (ys[bad[:5]], xs[bad[:5]], got[bad[:5]])
    normal = ~(_subnormal(ys) | _subnormal(xs) | _subnormal(got))
    assert normal.sum() > 0.97 * len(got)
    want = np.asarray(jax_trig[2](jnp.asarray(ys), jnp.asarray(xs)))
    bad = _same_bits(got[normal], want[normal])
    assert bad.size == 0, (ys[normal][bad[:5]], xs[normal][bad[:5]], got[normal][bad[:5]])
    assert (libm.atan2f(torch.from_numpy(ys[:M // 4]), torch.from_numpy(xs[:M // 4]))
            != torch.atan2(torch.from_numpy(ys[:M // 4]), torch.from_numpy(xs[:M // 4]))).any()


def test_atan2_special_cases():
    """Signed zeros, the axes, x = 1 and the extreme ratios, one by one."""
    f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    cases = [(0.0, -0.0), (-0.0, -0.0), (-0.0, 5.0), (0.0, -5.0), (3.0, 0.0),
             (-3.0, -0.0), (7.0, 1.0), (-0.25, 1.0), (2.0**61, 1.5), (1.5, -(2.0**61)),
             (-1.5, 2.0**61), (np.inf, -np.inf), (-np.inf, np.inf), (5.0, np.inf),
             (-5.0, -np.inf)]
    ys, xs = (np.array(v, F32) for v in zip(*cases))
    got = libm.atan2f(f(ys), f(xs)).numpy()
    assert _same_bits(got, _oracle_atan2(ys, xs)).size == 0
    assert np.signbit(got[2]) and not np.signbit(got[0])


def _large():
    """Floats from 120 to 2^127, log-uniform, both signs, and the edges of
    every binade from 2^7 up to the largest float."""
    rng = np.random.RandomState(5)
    e = rng.uniform(np.log2(120.0), 127.99, M // 4)
    xs = (np.exp2(e) * rng.choice([-1.0, 1.0], e.size)).astype(F32)
    tops = np.ldexp(np.ones(121), np.arange(7, 128)).astype(F32)
    edges = np.concatenate([tops, np.nextafter(tops, F32(np.inf)),
                            np.array([120.0, np.finfo(F32).max], F32)])
    return np.concatenate([xs, edges, -edges])


@pytest.mark.parametrize("name", ["cosf", "sinf"])
def test_large_arguments_match_glibc_and_jax(name, jax_trig):
    xs = _large()
    got = getattr(libm, name)(torch.from_numpy(xs)).numpy()
    assert not np.isnan(got).any()
    bad = _same_bits(got, _oracle1(name, xs))
    assert bad.size == 0, (xs[bad[:5]], got[bad[:5]])
    jfn = jax_trig[0] if name == "cosf" else jax_trig[1]
    bad = _same_bits(got, np.asarray(jfn(jnp.asarray(xs))))
    assert bad.size == 0, (xs[bad[:5]], got[bad[:5]])


def test_large_arguments_are_not_ported():
    """|x| >= 120 goes through glibc's reduce_large, ported since the
    generated-assets slice: finite inputs give glibc's bits, one by one
    around the switch at 120, and only infinities and NaN give NaN."""
    xs = np.array([120.0, -120.0, np.nextafter(F32(120.0), F32(0)), -500.0, 1e30,
                   -3.4e38, np.inf, -np.inf, np.nan], F32)
    for name in ("cosf", "sinf"):
        got = getattr(libm, name)(torch.from_numpy(xs)).numpy()
        assert _same_bits(got, _oracle1(name, xs)).size == 0
        assert np.isnan(got[-3:]).all() and not np.isnan(got[:-3]).any()


def test_no_fused_or_library_trig_on_the_path():
    """Starpilot's and caveflyer's steps take their trig from
    ``core/libm.py`` alone, and the module fuses no multiply into an
    add."""
    from procgen_tpu_torch.games import caveflyer, starpilot

    for mod in (starpilot, caveflyer, libm):
        # the code, without its docstrings and comments
        code = "\n".join(ln.split("#")[0] for ln in inspect.getsource(mod).splitlines())
        code = code.replace(inspect.getdoc(mod) or "", "")
        for banned in ("torch.cos(", "torch.sin(", "torch.atan2(", "math.cos(",
                       "math.sin(", "math.atan2(", ".cos()", ".sin()", "addcmul",
                       "addcdiv", "lerp", "baddbmm", "torch.fma"):
            assert banned not in code, (mod.__name__, banned)


def _glibc_f64():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for name in ("cos", "sin"):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_double, [ctypes.c_double]
    lib.atan2.restype = ctypes.c_double
    lib.atan2.argtypes = [ctypes.c_double, ctypes.c_double]
    return lib


def test_caveflyer_double_trig_matches_glibc():
    """Caveflyer's C++ double expressions, in the port's f64 forms, against
    glibc's double ``cos``, ``sin`` and ``atan2``: on 65,536 headings from
    -10^4 to 10^4 rad (1,024 of them within 2^-20 of a quarter turn) the
    thrust ``f32(accel * cos(theta))``, ``sin`` likewise, and the exhaust's
    ``f32(x - rx * cos(theta))``; on every axis velocity an enemy takes
    (``vx`` or ``vy`` zero of either sign, the other of either sign, speeds
    from 0.05 to 0.2) the heading ``f32(-atan2(vy, vx) - PI / 2)``; all
    bit-equal.  Off the axes fdlibm's ``atan2`` stays within an ulp of
    glibc's in double."""
    lib = _glibc_f64()
    rs = np.random.RandomState(14)
    theta = rs.uniform(-1e4, 1e4, 65536).astype(F32)
    k = rs.randint(-6366, 6367, 1024)
    theta[:1024] = (k * (np.pi / 2) + rs.uniform(-2**-20, 2**-20, 1024)).astype(F32)
    accel = rs.choice(np.array([1.0, -0.33], F32), theta.size)
    x = rs.uniform(0, 60, theta.size).astype(F32)
    rx = rs.choice(np.array([0.4, 0.5, 0.25], F32), theta.size)
    sin_d, cos_d = (t.numpy() for t in libm.sincos_f64(torch.from_numpy(theta)))
    want_c = np.array([lib.cos(float(t)) for t in theta])
    want_s = np.array([lib.sin(float(t)) for t in theta])
    a64 = accel.astype(np.float64)
    for got, want in ((sin_d, want_s), (cos_d, want_c)):
        np.testing.assert_array_equal((a64 * got).astype(F32), (a64 * want).astype(F32))
    np.testing.assert_array_equal(
        (x.astype(np.float64) - rx.astype(np.float64) * cos_d).astype(F32),
        (x.astype(np.float64) - rx.astype(np.float64) * want_c).astype(F32))

    v = rs.uniform(0.05, 0.2, 4096).astype(F32)
    sign = rs.choice([-1.0, 1.0], (4096, 2)).astype(F32)
    zero = rs.choice(np.array([0.0, -0.0], F32), 4096)
    on_x = rs.rand(4096) < 0.5
    vx = np.where(on_x, sign[:, 0] * v, zero).astype(F32)
    vy = np.where(on_x, zero, sign[:, 1] * v).astype(F32)
    half = float(HALF_PI)
    got = (-libm.atan2_f64(torch.from_numpy(vy), torch.from_numpy(vx)).numpy() - half)
    want = np.array([-lib.atan2(float(b), float(a)) - half for a, b in zip(vx, vy)])
    np.testing.assert_array_equal(got.astype(F32), want.astype(F32))

    y2, x2 = (rs.uniform(-16, 16, (2, 65536)) * np.exp2(rs.randint(-8, 9, (2, 65536)))
              ).astype(F32)
    got = libm.atan2_f64(torch.from_numpy(y2), torch.from_numpy(x2)).numpy()
    want = np.array([lib.atan2(float(b), float(a)) for a, b in zip(x2, y2)])
    assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()
