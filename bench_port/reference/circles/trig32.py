"""float32 ``sin``, ``cos``, ``atan2`` and ``asin`` with the JAX package's bits.

The JAX package computes its tables with XLA:CPU, whose float32 ``sin``,
``cos`` and ``arctan2`` call glibc's ``sinf``, ``cosf`` and ``atan2f``
(glibc 2.36; ``sinf``/``cosf`` in their FMA build, which x86-64 machines
with AVX2 and FMA select), and whose ``arcsin`` is expanded as
``2 * atan2(x, 1 + sqrt((1 - x) * (1 + x)))`` in float32.  PyTorch's own
``sin``/``cos``/``atan2`` and numpy's float32 ones are other
approximations and differ from these in the last bit on a few percent of
inputs, which flips leg bits at circle boundaries.

Every function here is written as elementwise tensor arithmetic (IEEE adds,
multiplies, divides, integer bit operations and selects, one operation per
tensor call, so no compiler can fuse a multiply into an add), and gives the
same bits on CPU tensors and on the card:

* ``sin``/``cos``: the algorithm of glibc's ``sinf``/``cosf`` (from Arm's
  optimized-routines).  The argument goes to double, is reduced by
  ``n * pi/2`` (``|x| < 120``: ``n`` from a scaled product, the reduction
  one rounding of ``x - n * pi/2`` as the FMA build has it, with ``pi/2``
  in two parts whose products are exact; larger: the 4/pi bit table of
  ``reduce_large``), a degree-7 (sine) or degree-8 (cosine) polynomial is
  evaluated in double and rounded once to float32.  glibc fuses the
  polynomial's multiply-adds; here each is two roundings in double, which
  moves the double result by an ulp or two of double, far below the
  float32 rounding it feeds (the tests hold every function to XLA on
  10^6 inputs).
* ``atan2``: fdlibm's ``__ieee754_atan2f`` and ``atanf``, all in float32,
  special cases (zeros, infinities, NaN, ``x == 1``) included.
* ``asin``: XLA's expansion above, with a correctly rounded square root.

:func:`sqrt` is a correctly rounded float32 square root (``torch.sqrt``
on the CPU is not, in float32 nor in float64), as XLA's and the card's
IEEE ``sqrtf`` are.
"""

from __future__ import annotations

import functools
import struct

import torch

__all__ = ["sin", "cos", "sincos", "host_sincos", "atan2", "asin", "sqrt"]


def _f(bits: int) -> float:
    """The float32 value with IEEE bit pattern ``bits``, as a Python float."""
    return struct.unpack("<f", struct.pack("<I", bits))[0]


# --- sinf / cosf -------------------------------------------------------------
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")  # 2/pi * 2^24
_HPI = float.fromhex("0x1.921fb54442d18p+0")        # pi/2 in double
# pi/2 = _HPI1 + _HPI2 exactly, 25 significant bits each: for |n| < 2^7
# both n * _HPIk and x - n * _HPI1 are exact, so the last subtraction rounds
# x - n * _HPI once, as the fused multiply-add does.
_HPI1 = float.fromhex("0x1.921fb5p+0")
_HPI2 = float.fromhex("0x1.110b46p-26")
_C0 = 1.0
_C1 = float.fromhex("-0x1.ffffffd0c621cp-2")
_C2 = float.fromhex("0x1.55553e1068f19p-5")
_C3 = float.fromhex("-0x1.6c087e89a359dp-10")
_C4 = float.fromhex("0x1.99343027bf8c3p-16")
_S1 = float.fromhex("-0x1.555545995a603p-3")
_S2 = float.fromhex("0x1.1107605230bc4p-7")
_S3 = float.fromhex("-0x1.994eb3774cf24p-13")
_PI63 = float.fromhex("0x1.921fb54442d18p-62")      # pi * 2^-63
#: 4/pi in bits, 24 words, indexed by the exponent (reduce_large)
_INV_PIO4 = (
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415,
    0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5,
    0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62, 0xc0db6295,
    0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041,
)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _sin_poly(r, r2):
    """glibc's sine polynomial: r + r^3 s1 + r^5 (s2 + r^2 s3)."""
    r3 = r * r2
    s1 = _S2 + r2 * _S3
    r5 = r3 * r2
    s = r + r3 * _S1
    return s + r5 * s1


def _cos_poly(r2):
    """glibc's cosine polynomial: c0 + r^2 c1 + r^4 c2 + r^6 (c3 + r^2 c4)."""
    r4 = r2 * r2
    c2 = _C3 + r2 * _C4
    c1 = _C0 + r2 * _C1
    r6 = r4 * r2
    c = c1 + r4 * _C2
    return c + r6 * c2


@functools.lru_cache(maxsize=8)
def _inv_pio4(device: torch.device) -> torch.Tensor:
    """The 4/pi words as an int64 tensor on ``device``, moved there once."""
    return torch.tensor(_INV_PIO4, dtype=torch.int64, device=device)


def _reduce_large(ax: torch.Tensor):
    """``reduce_large`` of glibc's sinf: (r in double, n) for the magnitude
    bits ``ax`` (int64), from 4/pi's bits, in 64-bit integer arithmetic
    (int64 wraps as the unsigned original does)."""
    table = _inv_pio4(ax.device)
    idx = (ax >> 26) & 15
    shift = (ax >> 23) & 7
    m = ((ax & 0xFFFFFF) | 0x800000) << shift
    res0 = (m * table[idx]) & 0xFFFFFFFF
    res1 = m * table[idx + 4]
    res2 = m * table[idx + 8]
    res0 = (res2 >> 32) | (res0 << 32)
    res0 = res0 + res1
    n = ((res0 + (1 << 61)) >> 62) & 3
    res0 = res0 - (n << 62)
    return res0.to(torch.float64) * _PI63, n


def sincos(x: torch.Tensor):
    """(``sinf(x)``, ``cosf(x)``) of float32 ``x``, elementwise, as glibc's
    ``sinf`` and ``cosf`` give them (one reduction serves both)."""
    y = x.to(torch.float32)
    ix = _bits(y).to(torch.int64)
    ax = ix & 0x7FFFFFFF
    top = ax >> 20
    neg = ix < 0
    xd = y.to(torch.float64)

    small = top <= 0x3F3          # |x| < 0.75: no reduction
    fast = top <= 0x42E           # |x| < 120: n from a scaled product
    # fast reduction, on inputs that take it (others would overflow int32)
    t = torch.where(fast & ~small, xd * _HPI_INV, torch.zeros_like(xd))
    n_fast = (t.to(torch.int32).to(torch.int64) + 0x800000) >> 24
    nd = n_fast.to(torch.float64)
    r_fast = (xd - nd * _HPI1) - nd * _HPI2
    r_large, n_large = _reduce_large(torch.where(fast, 0, ax))

    r = torch.where(small, xd, torch.where(fast, r_fast, r_large))
    n = torch.where(small, 0, torch.where(fast, n_fast, n_large))
    # sign and table choice: n itself on the fast path; n + the input's
    # sign on the large one (its r is of |x|)
    m = torch.where(fast, n, n + neg.to(torch.int64))
    r2 = r * r
    sp = _sin_poly(r, r2)
    cp = _cos_poly(r2)
    sgn_s = torch.where(((m & 3) == 1) | ((m & 3) == 2), -1.0, 1.0).to(
        torch.float64)
    sgn_c = torch.where((m & 2) != 0, -1.0, 1.0).to(torch.float64)
    s_branch = (sgn_s * sp).to(torch.float32)
    c_branch = (sgn_c * cp).to(torch.float32)
    odd = (n & 1) != 0
    s = torch.where(odd, c_branch, s_branch)
    c = torch.where(odd, s_branch, c_branch)
    tiny = top <= 0x397           # |x| < 2^-12
    s = torch.where(tiny, y, s)
    c = torch.where(tiny, torch.ones_like(y), c)
    bad = top > 0x7F7             # inf, NaN
    nan = y - y
    return torch.where(bad, nan, s), torch.where(bad, nan, c)


def host_sincos(angles):
    """(sin list, cos list) of Python numbers taken as float32 angles, as
    Python floats: the form of the kernels' by-value leg constants."""
    s, c = sincos(torch.tensor([float(a) for a in angles],
                               dtype=torch.float32))
    return s.tolist(), c.tolist()


def sin(x: torch.Tensor) -> torch.Tensor:
    """glibc's ``sinf``, elementwise (see :func:`sincos`)."""
    return sincos(x)[0]


def cos(x: torch.Tensor) -> torch.Tensor:
    """glibc's ``cosf``, elementwise (see :func:`sincos`)."""
    return sincos(x)[1]


# --- atanf / atan2f (fdlibm, float32) ----------------------------------------
_ATANHI = (_f(0x3EED6338), _f(0x3F490FDA), _f(0x3F7B985E), _f(0x3FC90FDA))
_ATANLO = (_f(0x31AC3769), _f(0x33222168), _f(0x33140FB4), _f(0x33A22168))
_AT = (_f(0x3EAAAAAB), _f(0xBE4CCCCD), _f(0x3E124925), _f(0xBDE38E38),
       _f(0x3DBA2E6E), _f(0xBD9D8795), _f(0x3D886B35), _f(0xBD6EF16B),
       _f(0x3D4BDA59), _f(0xBD15A221), _f(0x3C8569D7))
_PI = _f(0x40490FDB)
_PI_O_2 = _f(0x3FC90FDB)
_PI_O_4 = _f(0x3F490FDB)
_PI_LO = _f(0xB3BBBD2E)
#: float32 results of fdlibm's constant expressions, as glibc rounds them:
#: pi_o_2 + 0.5 pi_lo, 3 pi_o_4 (+ tiny) and atanhi[3] + atanlo[3]
_PIO2_NEAR = _f(0x3FC90FDB)
_THREE_PI_O_4 = _f(0x4016CBE4)
_ATAN_INF = _f(0x3FC90FDB)


@functools.lru_cache(maxsize=8)
def _atan_table(device: torch.device) -> torch.Tensor:
    """``[2, 4]`` float32: atan's high and low parts at the reduction
    points 0.5, 1, 1.5 and infinity, on ``device``, moved there once."""
    return torch.tensor([_ATANHI, _ATANLO], dtype=torch.float32,
                        device=device)


def _atanf(x: torch.Tensor) -> torch.Tensor:
    """fdlibm's ``atanf`` in float32, elementwise."""
    hx = _bits(x)
    ix = hx & 0x7FFFFFFF
    a = torch.abs(x)
    # the argument reduction: id -1 (|x| < 0.4375, none), 0, 1, 2 or 3
    near = ix < 0x3EE00000
    i1, i2, i3 = ix >= 0x3F300000, ix >= 0x3F980000, ix >= 0x401C0000
    t = torch.where(
        i2,
        torch.where(i3, -1.0 / a, (a - 1.5) / (a * 1.5 + 1.0)),
        torch.where(i1, (a - 1.0) / (a + 1.0), (a + a - 1.0) / (a + 2.0)))
    t = torch.where(near, x, t)
    z = t * t
    w = z * z
    s1 = _AT[10] * w + _AT[8]
    for k in (6, 4, 2, 0):
        s1 = s1 * w + _AT[k]
    s1 = s1 * z
    s2 = _AT[9] * w + _AT[7]
    for k in (5, 3, 1):
        s2 = s2 * w + _AT[k]
    s2 = s2 * w
    u = (s1 + s2) * t
    hi, lo = _atan_table(x.device)[:, (i1.to(torch.int64) + i2.to(torch.int64)
                                       + i3.to(torch.int64))]
    far = hi - ((u - lo) - t)
    out = torch.where(near, t - u, torch.where(hx < 0, -far, far))
    out = torch.where(ix < 0x31000000, x, out)          # |x| < 2^-29
    big = torch.where(hx < 0, -_ATAN_INF, _ATAN_INF)
    out = torch.where(ix >= 0x4C000000, big, out)       # |x| >= 2^25
    return torch.where(ix > 0x7F800000, x + x, out)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """fdlibm's ``atan2f`` (glibc's), elementwise over float32 tensors that
    broadcast.

    Its special case ``x == 1`` (``atanf(y)``) is left to the general path,
    which gives the same bits for every ``y``: ``atanf`` is odd, and for
    ``|y| >= 2^61`` both round to the float32 of pi/2."""
    y, x = torch.broadcast_tensors(y.to(torch.float32), x.to(torch.float32))
    hx, hy = _bits(x), _bits(y)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    xneg = hx < 0
    k = (iy - ix) >> 23
    z = _atanf(torch.abs(y / x))
    z = torch.where(k > 60, _PIO2_NEAR,
                    torch.where(xneg & (k < -60), 0.0, z))
    # the magnitude by x's sign (quadrants 1-2), y's sign applied last:
    # (z - pi_lo) - pi is -(pi - (z - pi_lo)) exactly
    base = torch.where(xneg, _PI - (z - _PI_LO), z)
    x_inf, y_inf = ix == 0x7F800000, iy == 0x7F800000
    base = torch.where(y_inf, _PI_O_2, base)
    axis = torch.where(xneg, _PI, 0.0)  # y = 0, or x infinite, y finite
    base = torch.where(
        x_inf, torch.where(y_inf, torch.where(xneg, _THREE_PI_O_4, _PI_O_4),
                           axis), base)
    base = torch.where(ix == 0, _PI_O_2, base)
    base = torch.where(iy == 0, axis, base)
    out = torch.where(hy < 0, -base, base)
    return torch.where((ix > 0x7F800000) | (iy > 0x7F800000), x + y, out)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, elementwise.

    ``torch.sqrt`` on the CPU is not correctly rounded in its vectorised
    loops, in float32 nor in float64, so the double root rounded to
    float32 (``r``, at most one ulp off) is corrected exactly: the
    midpoints between ``r`` and its neighbours have 25 significant bits,
    so their squares are exact in double and compare with ``x`` without
    error (no float32 ``x`` equals such a square, so there are no ties).
    On a CUDA tensor float32 ``torch.sqrt`` is the card's IEEE ``sqrtf``,
    correctly rounded already, and is taken as it is (the same bits:
    ``chip_smoke.py`` holds the card's results to the host's).
    """
    x = x.to(torch.float32)
    if x.is_cuda:
        return torch.sqrt(x)
    xd = x.to(torch.float64)
    r = torch.sqrt(xd).to(torch.float32)
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    dn = torch.nextafter(r, torch.zeros_like(r))
    rd = r.to(torch.float64)
    hi = (rd + up.to(torch.float64)) * 0.5
    lo = (rd + dn.to(torch.float64)) * 0.5
    fixed = torch.where(xd > hi * hi, up, torch.where(xd < lo * lo, dn, r))
    return torch.where(x > 0, fixed, r)


def asin(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``arcsin``: ``2 atan2(x, 1 + sqrt((1 - x)(1 + x)))``."""
    x = x.to(torch.float32)
    return 2.0 * atan2(x, 1.0 + sqrt((1.0 - x) * (1.0 + x)))
