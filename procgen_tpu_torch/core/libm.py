"""glibc's ``sinf``, ``cosf`` and ``atan2f`` as elementwise torch ops.

The JAX package's trig on the CPU is glibc's: XLA calls ``sinf``, ``cosf``
and ``atan2f`` of libm, as the C++ reference does.  ``torch.sin``,
``torch.cos`` and ``torch.atan2`` use other algorithms (SLEEF on the CPU,
CUDA's libdevice on the card) and differ from it in the last bit on a few
percent of the inputs, which a game step turns into a diverging
trajectory.  Here the same algorithms run as explicit IEEE tensor
operations, one rounding each, so the CPU and the card give the same bits
and those are glibc 2.36's (x86_64):

* ``sinf`` / ``cosf`` (and both at once, ``sincosf``):
  ``sysdeps/ieee754/flt-32/s_sinf.c``, ``s_cosf.c`` and ``sincosf.h``
  (ARM's optimized-routines), with internals in f64.
  glibc's ifunc runs the ``-mfma -mavx2`` build of these files on a CPU
  with FMA and AVX2, in which the compiler fused every ``a * b + c`` of
  the polynomial and of the range reduction into one rounding; that build
  is the one matched here, each such fused step emulated exactly with
  error-free transformations (``_fma``).  Inputs with ``|x| >= 120`` take
  ``reduce_large``: 4/pi to 192 bits (``__inv_pio4``, derived here from pi
  to 120 digits) times the 24-bit mantissa, its uint64 products and
  shifts emulated in int64 halves of 32 bits.
* ``atan2f``: fdlibm's ``e_atan2f.c`` and ``s_atanf.c`` (glibc's
  ``sysdeps/ieee754/flt-32``), in f32, unfused.
* ``sincos_times``: a double ``sin``/``cos`` times an f32 speed, rounded
  once to f32 (starpilot's spawners, bossfight's bullets), on fdlibm's
  f64 reduction and kernels (``sincos_f64``, the double values
  themselves, for caveflyer's headings and exhaust); ``atan2_f64``:
  fdlibm's double ``atan2`` (caveflyer's enemy headings).

Every operation takes a tensor operand or a Python float that is exact in
the operation's dtype; no torch op that fuses a multiply and an add
(``addcmul``, ``lerp``, ...) is used.
"""

from __future__ import annotations

import struct

import torch

f32 = torch.float32
f64 = torch.float64
i32 = torch.int32
i64 = torch.int64


def _f(v: float) -> float:
    """``v`` rounded to f32, as a Python float (exact), as a C compiler
    rounds a float literal."""
    return struct.unpack("<f", struct.pack("<f", v))[0]


# -- sincosf.h / sincosf_data.c ------------------------------------------------

_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")  # 2/pi * 2^24
_HPI = float.fromhex("0x1.921FB54442D18p0")  # pi/2
# cosine polynomial c0..c4 of __sincosf_table[0]; table[1] negates them
_C = (1.0, float.fromhex("-0x1.ffffffd0c621cp-2"),
      float.fromhex("0x1.55553e1068f19p-5"),
      float.fromhex("-0x1.6c087e89a359dp-10"),
      float.fromhex("0x1.99343027bf8c3p-16"))
# sine polynomial s1..s3 (the same in both tables)
_S1 = float.fromhex("-0x1.555545995a603p-3")
_S2 = float.fromhex("0x1.1107605230bc4p-7")
_S3 = float.fromhex("-0x1.994eb3774cf24p-13")
# abstop12 bounds as |word| bounds: 0x1p-12f and 120.0f
_ABS_TINY = 0x39800000
_ABS_120 = 0x42F00000
_SPLIT = 134217729.0  # 2^27 + 1, Veltkamp's splitter for f64
_ABS_INF = 0x7F800000
_PI63 = float.fromhex("0x1.921FB54442D18p-62")  # pi/2 * 2^-62
_M32 = 0xFFFFFFFF


def _inv_pio4() -> tuple:
    """glibc's ``__inv_pio4`` (sincosf_data.c): entry k holds the bits
    8k + 1 .. 8k + 32 of 2/pi after the binary point, 8 new bits an entry.
    Derived from pi to 120 digits by Machin's formula in ``decimal``."""
    from decimal import Decimal, localcontext

    with localcontext() as ctx:
        ctx.prec = 120
        eps = Decimal(10) ** -118

        def atan_inv(n):  # arctan(1/n)
            x = Decimal(1) / n
            term, total, k = x, x, 1
            while abs(term) > eps:
                term = -term * x * x
                total += term / (2 * k + 1)
                k += 1
            return total

        pi = 16 * atan_inv(5) - 4 * atan_inv(239)
        bits = int(Decimal(2) / pi * Decimal(2) ** 200)  # floor(2/pi * 2^200)
    return tuple((bits >> (192 - 8 * k)) & _M32 for k in range(24))


_INV_PIO4 = _inv_pio4()


def _two_sum(a, b):
    """(s, t) with s = fl(a + b) and a + b = s + t exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    """Veltkamp's split of an f64 into two halves of 26 bits."""
    t = a * _SPLIT
    hi = t - (t - a)
    return hi, a - hi


def _fma(a, b, c):
    """fl(a * b + c) with one rounding, in f64 (each of ``b`` and ``c`` a
    tensor or a Python float): the exact product (Dekker), its sum with
    ``c`` split exactly, the two low parts added with rounding to odd,
    then one rounding to nearest (Boldo and Melquiond, "Emulation of FMA
    and correctly rounded sums", 2008)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, p)
    u, v = _two_sum(tl, e)
    # round to odd: an inexact u with an even last bit moves one ulp
    # toward v (away from zero where v has u's sign)
    bits = u.view(i64)
    step = torch.where((v > 0) == (u > 0), 1, -1)
    odd = torch.where((v != 0) & ((bits & 1) == 0), bits + step, bits)
    return th + odd.view(f64)


def _reduce_large(absw: torch.Tensor):
    """sincosf.h ``reduce_large`` of the words of ``|y|`` (int32, sign
    cleared): (x f64 in [-pi/4, pi/4], n int64 in 0..3) with |y| = n * pi/2
    + x modulo 2 pi.  Each uint64 of the C is a pair of 32-bit halves in
    int64 tensors; every product below is of a 31-bit and a 32-bit word,
    so none leaves int64."""
    w = absw.to(i64)
    tab = torch.tensor(_INV_PIO4, dtype=i64, device=w.device)
    k = (w >> 26) & 15
    xi = ((w & 0xFFFFFF) | 0x800000) << ((w >> 23) & 7)
    # res0 = (uint32)(xi * arr[0]) << 32 | (xi * arr[8]) >> 32
    hi = (xi * tab[k]) & _M32
    lo = (xi * tab[k + 8]) >> 32
    # res0 += xi * arr[4]
    r1 = xi * tab[k + 4]
    lo = lo + (r1 & _M32)
    hi = (hi + (r1 >> 32) + (lo >> 32)) & _M32
    lo = lo & _M32
    # n = (res0 + 2^61) >> 62; res0 -= n << 62
    n = ((hi + (1 << 29)) & _M32) >> 30
    hi = (hi - (n << 30)) & _M32
    res0 = torch.where(hi >= 1 << 31, hi - (1 << 32), hi) * (1 << 32) + lo
    return res0.to(f64) * _PI63, n


def sincosf(y: torch.Tensor):
    """glibc 2.36's ``(sinf(y), cosf(y))`` of an f32 tensor.  Below 120 one
    reduction serves both: ``reduce_fast`` gives the quadrant n and x - n *
    pi/2 (one fused step), and each function is the sine polynomial of n's
    parity or the cosine one (table 1, the negated coefficients, where n &
    2).  Below 0.75, where glibc skips the reduction, n is 0 and the
    reduction returns x itself.  From 120 on, ``reduce_large`` reduces
    |y|, n's parity picks the polynomial and n plus y's sign bit the signs
    and the table.  Infinities and NaN give NaN."""
    y = y.to(f32)
    word = y.view(i32)
    absw = word & 0x7FFFFFFF
    x = y.to(f64)
    n = ((x * _HPI_INV).to(i64) + 0x800000) >> 24
    xr = _fma(-n.to(f64), _HPI, x)
    big = absw >= _ABS_120
    x_large, n_large = _reduce_large(absw)
    xr = torch.where(big, x_large, xr)
    # q: the quadrant of the signs and the table; n: of the polynomial
    q = torch.where(big, n_large + ((word >> 31) & 1).to(i64), n)
    n = torch.where(big, n_large, n)
    xs = torch.where(((q & 3) == 1) | ((q & 3) == 2), -xr, xr)
    x2 = xr * xr
    # sinf_poly, n even: the sine polynomial
    x3 = xs * x2
    s1 = _fma(x2, _S3, _S2)
    x7 = x3 * x2
    sin_r = _fma(x7, s1, _fma(x3, _S1, xs))
    # n odd: the cosine polynomial of table 0, negated for table 1 (round
    # to nearest is symmetric, so every fused step negates exactly)
    x4 = x2 * x2
    c2 = _fma(x2, _C[4], _C[3])
    c1 = _fma(x2, _C[1], _C[0])
    x6 = x4 * x2
    cos_r = _fma(x6, c2, _fma(x4, _C[2], c1))
    cos_r = torch.where((q & 2) != 0, -cos_r, cos_r)
    odd = (n & 1) != 0
    sin = torch.where(odd, cos_r, sin_r).to(f32)
    cos = torch.where(odd, sin_r, cos_r).to(f32)
    sin = torch.where(absw < _ABS_TINY, y, sin)
    cos = torch.where(absw < _ABS_TINY, 1.0, cos)
    bad = absw >= _ABS_INF
    return torch.where(bad, torch.nan, sin), torch.where(bad, torch.nan, cos)


def sinf(x: torch.Tensor) -> torch.Tensor:
    """glibc 2.36's ``sinf`` of an f32 tensor."""
    return sincosf(x)[0]


def cosf(x: torch.Tensor) -> torch.Tensor:
    """glibc 2.36's ``cosf`` of an f32 tensor."""
    return sincosf(x)[1]


# -- s_atanf.c / e_atan2f.c (fdlibm) -------------------------------------------

# the float literals of s_atanf.c and e_atan2f.c (fdlibm's comments give
# aT[0]'s word as 0x3eaaaaaa; the literal rounds to 0x3eaaaaab)
_ATANHI = tuple(map(_f, (4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01,
                         1.5707962513e+00)))
_ATANLO = tuple(map(_f, (5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08,
                         7.5497894159e-08)))
_AT = tuple(map(_f, (
    3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01, -1.1111110449e-01,
    9.0908870101e-02, -7.6918758452e-02, 6.6610731184e-02, -5.8335702866e-02,
    4.9768779427e-02, -3.6531571299e-02, 1.6285819933e-02,
)))
_PI_O_4 = _f(7.8539818525e-01)
_PI_O_2 = _f(1.5707963705e+00)
_PI = _f(3.1415927410e+00)
_PI_LO = _f(-8.7422776573e-08)


# fdlibm's k_sin.c / k_cos.c kernel polynomials for |x| <= pi/4, f64
_KS = (-1.66666666666666324348e-01, 8.33333333332248946124e-03,
       -1.98412698298579493134e-04, 2.75573137070700676789e-06,
       -2.50507602534068634195e-08, 1.58969099521155010221e-10)
_KC = (4.16666666666666019037e-02, -1.38888888888741095749e-03,
       2.48015872894767294178e-05, -2.75573143513906633035e-07,
       2.08757232129817482790e-09, -1.13596475577881948265e-11)


def _kernel_sin(x: torch.Tensor, y=None) -> torch.Tensor:
    """fdlibm's ``__kernel_sin(x, y, iy)``: f64, |x| <= pi/4, ``y`` the
    tail of a reduced argument (iy = 1) or None (iy = 0)."""
    s1, s2, s3, s4, s5, s6 = _KS
    z = x * x
    v = z * x
    r = s2 + z * (s3 + z * (s4 + z * (s5 + z * s6)))
    if y is None:
        return x + v * (s1 + z * r)
    return x - ((z * (0.5 * y - v * r) - y) - v * s1)


def _kernel_cos(x: torch.Tensor, y=None) -> torch.Tensor:
    """fdlibm's ``__kernel_cos(x, y)``: f64, |x| <= pi/4, ``y`` the tail
    (None: 0).  Above 0.3 it subtracts ``qx``, |x|/4 cut to its high word
    (0.28125 above 0.78125), first."""
    c1, c2, c3, c4, c5, c6 = _KC
    z = x * x
    r = z * (c1 + z * (c2 + z * (c3 + z * (c4 + z * (c5 + z * c6)))))
    zr = z * r if y is None else z * r - x * y
    small = 1.0 - (0.5 * z - zr)
    bits = torch.abs(x).view(i64)
    hi = bits >> 32
    q = ((bits - (0x00200000 << 32)) & ~0xFFFFFFFF).view(f64)
    q = torch.where(hi > 0x3FE90000, 0.28125, q)
    large = (1.0 - q) - ((0.5 * z - q) - zr)
    return torch.where(hi < 0x3FD33333, small, large)


# e_rem_pio2.c: 2/pi, and pi/2 as its first 33 bits and the rest
_INV_PIO2 = 6.36619772367581382433e-01
_PIO2_1 = 1.57079632673412561417e+00
_PIO2_1T = 6.07710050650619224932e-11


def sincos_f64(x: torch.Tensor):
    """C's double ``sin(x)`` and ``cos(x)`` as fdlibm computes them (s_sin.c,
    s_cos.c), f64 tensors, of an f32 or f64 tensor with |x| < 2^19 pi/2:
    up to |x| <= pi/4 the kernels alone, past it ``__ieee754_rem_pio2``'s
    first round (n = |x| 2/pi rounded, |x| - n pi/2 as a head and a tail;
    good to 85 bits, which an f32 argument never needs the second round
    past) and the kernel of n's quadrant.  The operands of a C++ float
    expression that calls them and is evaluated in double (caveflyer's
    exhaust, ``x - rx * cos(theta)``)."""
    x = x.to(f64)
    t = torch.abs(x)
    small = (t.view(i64) >> 32) <= 0x3FE921FB
    n = torch.trunc(t * _INV_PIO2 + 0.5)
    r = t - n * _PIO2_1
    w = n * _PIO2_1T
    y0 = r - w
    y1 = (r - y0) - w
    neg = x < 0
    y0 = torch.where(neg, -y0, y0)
    y1 = torch.where(neg, -y1, y1)
    q = torch.where(neg, -n, n).to(i64) & 3
    ks, kc = _kernel_sin(y0, y1), _kernel_cos(y0, y1)
    sin = torch.where(q == 0, ks, torch.where(q == 1, kc, torch.where(q == 2, -ks, -kc)))
    cos = torch.where(q == 0, kc, torch.where(q == 1, -ks, torch.where(q == 2, -kc, ks)))
    return (torch.where(small, _kernel_sin(x), sin),
            torch.where(small, _kernel_cos(x), cos))


def sincos_times(theta: torch.Tensor, v: torch.Tensor):
    """``(float)(sin(theta) * v)`` and ``(float)(cos(theta) * v)`` for f32
    ``theta`` (|theta| < 2^19 pi/2) and f32 ``v``, where ``sin``/``cos``
    are C's double functions: a C++ float expression that calls them is
    evaluated in double and rounded once to float.  The double sine and
    cosine are fdlibm's in explicit f64 operations, so the CPU and the card
    agree; glibc's are needed only as far as they reach the f32 result,
    and fdlibm's are held to them there at every heading of starpilot's
    spawners and each of its speeds (``tools/torch_libm_sweep.py
    --spawners``) and at bossfight's bullet headings
    (``tests/test_torch_bossfight.py``)."""
    sin, cos = sincos_f64(theta)
    v = v.to(f64)
    return (sin * v).to(f32), (cos * v).to(f32)


def _full(like, v):
    return torch.full_like(like, v)


def _atanf(x: torch.Tensor) -> torch.Tensor:
    """fdlibm's ``atanf`` of an f32 tensor."""
    hx = x.view(i32)
    ix = hx & 0x7FFFFFFF
    ax = torch.abs(x)
    one = _full(x, 1.0)
    # argument reduction: id -1 (none), 0, 1, 2, 3
    r0 = (2.0 * ax - 1.0) / (2.0 + ax)
    r1 = (ax - 1.0) / (ax + 1.0)
    r2 = (ax - 1.5) / (one + 1.5 * ax)
    r3 = _full(x, -1.0) / ax
    idx = torch.where(ix < 0x3EE00000, -1, torch.where(
        ix < 0x3F300000, 0, torch.where(
            ix < 0x3F980000, 1, torch.where(ix < 0x401C0000, 2, 3))))
    xr = torch.where(idx == -1, x, torch.where(idx == 0, r0, torch.where(
        idx == 1, r1, torch.where(idx == 2, r2, r3))))
    z = xr * xr
    w = z * z
    a = _AT
    s1 = z * (a[0] + w * (a[2] + w * (a[4] + w * (a[6] + w * (a[8] + w * a[10])))))
    s2 = w * (a[1] + w * (a[3] + w * (a[5] + w * (a[7] + w * a[9]))))
    near = xr - xr * (s1 + s2)
    k = idx.clamp_min(0).long()
    hi = torch.tensor(_ATANHI, dtype=f32, device=x.device)[k]
    lo = torch.tensor(_ATANLO, dtype=f32, device=x.device)[k]
    far = hi - ((xr * (s1 + s2) - lo) - xr)
    far = torch.where(hx < 0, -far, far)
    out = torch.where(idx == -1, near, far)
    out = torch.where(ix < 0x31000000, x, out)  # |x| < 2^-29
    # |x| >= 2^25: +-(atanhi[3] + atanlo[3]); NaN: x + x
    inf_v = _full(x, _ATANHI[3]) + _ATANLO[3]
    big = torch.where(hx > 0, inf_v, -inf_v)
    big = torch.where(ix > 0x7F800000, x + x, big)
    return torch.where(ix >= 0x4C000000, big, out)


def atan2f(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """glibc 2.36's (fdlibm's) ``atan2f`` of f32 tensors, broadcast."""
    y, x = torch.broadcast_tensors(y.to(f32), x.to(f32))
    hx, hy = x.view(i32), y.view(i32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)  # 2 * sign(x) + sign(y)
    pi = _full(x, _PI)
    pi_o_2 = _full(x, _PI_O_2)
    pi_o_4 = _full(x, _PI_O_4)

    # the general case: z = atan(|y / x|), then the quadrant
    k = (iy - ix) >> 23
    z = _atanf(torch.abs(y / x))
    z = torch.where((hx < 0) & (k < -60), 0.0, z)
    z = torch.where(k > 60, pi_o_2 + 0.5 * _PI_LO, z)
    zl = z - _PI_LO
    out = torch.where(m == 0, z, torch.where(
        m == 1, -z, torch.where(m == 2, pi - zl, zl - pi)))

    # the special cases, innermost last in the C's order of tests
    out = torch.where(iy == 0x7F800000, torch.where(hy < 0, -pi_o_2, pi_o_2), out)
    x_inf = torch.where(iy == 0x7F800000, torch.where(
        m == 0, pi_o_4, torch.where(m == 1, -pi_o_4, torch.where(
            m == 2, 3.0 * pi_o_4, -3.0 * pi_o_4))),
        torch.where(m == 0, 0.0, torch.where(
            m == 1, -0.0, torch.where(m == 2, pi, -pi))))
    out = torch.where(ix == 0x7F800000, x_inf, out)
    out = torch.where(ix == 0, torch.where(hy < 0, -pi_o_2, pi_o_2), out)
    y_zero = torch.where(m <= 1, y, torch.where(m == 2, pi, -pi))
    out = torch.where(iy == 0, y_zero, out)
    out = torch.where(hx == 0x3F800000, _atanf(y), out)
    return torch.where((ix > 0x7F800000) | (iy > 0x7F800000), x + y, out)


# -- s_atan.c / e_atan2.c (fdlibm), f64 -----------------------------------------

_DATANHI = (4.63647609000806093515e-01, 7.85398163397448278999e-01,
            9.82793723247329054082e-01, 1.57079632679489655800e+00)
_DATANLO = (2.26987774529616870924e-17, 3.06161699786838301793e-17,
            1.39033110312309984516e-17, 6.12323399573676603587e-17)
_DAT = (3.33333333333329318027e-01, -1.99999999998764832476e-01,
        1.42857142725034663711e-01, -1.11111104054623557880e-01,
        9.09088713343650656196e-02, -7.69187620504482999495e-02,
        6.66107313738753120669e-02, -5.83357013379057348645e-02,
        4.97687799461593236017e-02, -3.65315727442169155270e-02,
        1.62858201153657823623e-02)
_DPI = 3.1415926535897931160e+00
_DPI_O_2 = 1.5707963267948965580e+00
_DPI_LO = 1.2246467991473531772e-16


def _atan_f64(x: torch.Tensor) -> torch.Tensor:
    """fdlibm's double ``atan`` (s_atan.c) of a finite f64 tensor."""
    hx = (x.view(i64) >> 32).to(i32)
    ix = hx & 0x7FFFFFFF
    ax = torch.abs(x)
    one = _full(x, 1.0)
    r0 = (2.0 * ax - 1.0) / (2.0 + ax)
    r1 = (ax - 1.0) / (ax + 1.0)
    r2 = (ax - 1.5) / (one + 1.5 * ax)
    r3 = _full(x, -1.0) / ax
    idx = torch.where(ix < 0x3FDC0000, -1, torch.where(
        ix < 0x3FE60000, 0, torch.where(
            ix < 0x3FF30000, 1, torch.where(ix < 0x40038000, 2, 3))))
    xr = torch.where(idx == -1, x, torch.where(idx == 0, r0, torch.where(
        idx == 1, r1, torch.where(idx == 2, r2, r3))))
    z = xr * xr
    w = z * z
    a = _DAT
    s1 = z * (a[0] + w * (a[2] + w * (a[4] + w * (a[6] + w * (a[8] + w * a[10])))))
    s2 = w * (a[1] + w * (a[3] + w * (a[5] + w * (a[7] + w * a[9]))))
    near = xr - xr * (s1 + s2)
    k = idx.clamp_min(0).long()
    hi = torch.tensor(_DATANHI, dtype=f64, device=x.device)[k]
    lo = torch.tensor(_DATANLO, dtype=f64, device=x.device)[k]
    far = hi - ((xr * (s1 + s2) - lo) - xr)
    far = torch.where(hx < 0, -far, far)
    out = torch.where(idx == -1, near, far)
    out = torch.where(ix < 0x3E200000, x, out)  # |x| < 2^-29
    # |x| >= 2^66: +-(atanhi[3] + atanlo[3])
    inf_v = _full(x, _DATANHI[3]) + _DATANLO[3]
    return torch.where(ix >= 0x44100000, torch.where(hx > 0, inf_v, -inf_v), out)


def atan2_f64(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """C's double ``atan2(y, x)`` of finite f32 or f64 tensors, as an f64
    tensor: fdlibm's ``e_atan2.c`` in explicit f64 operations, the same
    bits on the CPU and the card (caveflyer's enemy headings, a C++ float
    expression that calls it, evaluated in double).  fdlibm's is within an
    ulp of glibc's; ``tests/test_torch_libm.py`` holds the two to the same
    f32 heading on the axis velocities caveflyer's enemies take (signed
    zeros, exact multiples of pi / 2), and to an ulp elsewhere."""
    y, x = torch.broadcast_tensors(y.to(f64), x.to(f64))
    hx = (x.view(i64) >> 32).to(i32)
    hy = (y.view(i64) >> 32).to(i32)
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)  # 2 * sign(x) + sign(y)
    pi = _full(x, _DPI)
    pi_o_2 = _full(x, _DPI_O_2)
    # the general case: z = atan(|y / x|), then the quadrant
    k = ((hy & 0x7FFFFFFF) - (hx & 0x7FFFFFFF)) >> 20
    z = _atan_f64(torch.abs(y / x))
    z = torch.where((hx < 0) & (k < -60), 0.0, z)
    z = torch.where(k > 60, pi_o_2 + 0.5 * _DPI_LO, z)
    out = torch.where(m == 0, z, torch.where(
        m == 1, -z, torch.where(m == 2, pi - (z - _DPI_LO), (z - _DPI_LO) - pi)))
    # the special cases, innermost last in the C's order of tests (pi +
    # tiny rounds to pi)
    out = torch.where(x == 0, torch.where(hy < 0, -pi_o_2, pi_o_2), out)
    y_zero = torch.where(m <= 1, y, torch.where(m == 2, pi, -pi))
    out = torch.where(y == 0, y_zero, out)
    return torch.where(x == 1.0, _atan_f64(y), out)
