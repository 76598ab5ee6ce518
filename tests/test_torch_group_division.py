"""The quantizer's division by a group's scale, emulated exactly.

``csrc/codec.cuh`` (``group_div`` / ``quant_fast``) quantizes a value by
its group's bf16 scale ``s`` with one reciprocal a group:
``y = __frcp_rn(s)``; per value ``a`` is clamped to ``[0, qmax * s]``, then
``q0 = __fmul_rn(a, y)``, ``r = __fmaf_rn(-q0, s, a)``,
``q = __fmaf_rn(r, y, q0)`` (Markstein's correction) and the code is
``__float2uint_rn(q)``. Outside ``s`` in ``[2^-100, 2^100]`` (or for an
fp16 scale) it divides with ``__fdiv_rn`` and clamps after. The kernels
must give IEEE float32 division's codes, so every step is emulated here
with exact rationals rounded to nearest even in float32 and held against
numpy's float32 division: on edge values and a seeded sweep of bf16
scales (``fractions.Fraction``), and, for whole bf16 significands, over
every float32 significand of ``a`` (integer arithmetic; run this file to
sweep all 128 significands)::

    python tests/test_torch_group_division.py
"""
import math
import sys
from fractions import Fraction

import numpy as np
import pytest
from _torch_threads import one_torch_thread  # noqa: E402,F401

LO, HI = 2.0 ** -100, 2.0 ** 100     # codec.cuh group_div: the fast range


def _rn32(x: Fraction) -> float:
    """An exact rational rounded to nearest even in float32 (subnormals
    and overflow included), as a Python float."""
    if x == 0:
        return 0.0
    sign = -1.0 if x < 0 else 1.0
    ax = abs(x)
    e = ax.numerator.bit_length() - ax.denominator.bit_length()
    if Fraction(2) ** e > ax:
        e -= 1                        # 2^e <= ax < 2^(e+1)
    quantum = Fraction(2) ** (max(e, -126) - 23)
    m, rem = divmod(ax, quantum)
    if rem * 2 > quantum or (rem * 2 == quantum and m % 2):
        m += 1
    v = m * quantum
    if v >= Fraction(2) ** 128:
        return sign * math.inf
    return sign * float(v)


def _op(exact, *xs) -> float:
    """One rounding of an exact operation on float32 operands; IEEE's
    special values where an operand is not finite."""
    if all(math.isfinite(x) for x in xs):
        return _rn32(exact(*(Fraction(x) for x in xs)))
    return _f32(exact(*xs))


def _mul(a, b):
    return _op(lambda x, y: x * y, a, b)


def _fma(a, b, c):
    return _op(lambda x, y, z: x * y + z, a, b, c)


def _rcp(s):
    return _op(lambda x: 1 / x, s)


def _fast(s: float, bf16: bool = True) -> bool:
    return bf16 and LO <= s <= HI


def _markstein(a: float, s: float) -> float:
    """codec.cuh quant_fast's quotient, without its clamp."""
    y = _rcp(s)
    q = _mul(a, y)
    return _fma(_fma(-q, s, a), y, q)


def _code(t: float, qmax: int) -> int:
    """The reference's code of a quotient: rint (half to even), clamp to
    [0, qmax], NaN -> 0."""
    if math.isnan(t):
        return 0
    return int(min(max(float(np.rint(np.float32(t))), 0.0), qmax))


def _kernel_code(a: float, s: float, qmax: int, bf16: bool = True):
    """codec.cuh quant_code8 -> (code, quotient or None)."""
    if not _fast(s, bf16):
        return _code(_ieee(a, s), qmax), None
    top = _mul(s, qmax)
    a = 0.0 if math.isnan(a) else min(max(a, 0.0), top)
    q = _markstein(a, s)
    assert q <= qmax, (a, s, q)
    return max(int(np.rint(q)), 0), q       # cvt.rni.u32 saturates below 0


def _f32(x) -> float:
    with np.errstate(over="ignore"):
        return float(np.float32(x))


def _ieee(a: float, s: float) -> float:
    """a / s in float32 (IEEE)."""
    with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
        return float(np.float32(a) / np.float32(s))


def _bf16(x: float) -> float:
    """x rounded to nearest even in bf16 (8 significant bits)."""
    u = int(np.array(x, np.float32).view(np.uint32))
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return float(np.array(u, np.uint32).view(np.float32))


def _scales(seed: int, count: int):
    """bf16 scales: the eps floor, powers of two, the largest significand,
    the fast range's ends, then random significands and exponents."""
    rng = np.random.default_rng(seed)
    fixed = [_bf16(1e-12), 1.0, 0.5, 2.0 ** -40, _f32(255 / 128),
             _f32(255 / 128 * 2.0 ** 99), LO, HI, _f32(129 / 128),
             _f32(181 / 128 * 2.0 ** -17), 3.0, 0.0078125]
    rand = [_f32(int(m) / 128 * 2.0 ** int(e)) for m, e in zip(
        rng.integers(128, 256, count), rng.integers(-40, 40, count))]
    return fixed + rand


def _values(s: float, qmax: int, rng) -> list:
    """Values a around s: every tie (k + 1/2) s and a float32 ulp either
    side, the clamp's ends, zeros, subnormals, infinities, NaN and
    random values up to a few qmax * s."""
    out = [0.0, -0.0, 1e-45, -1e-45, 2.0 ** -126, math.inf, -math.inf,
           math.nan, 3e38, -3e38]
    top = np.float32(s * qmax)
    for t in [np.float32((k + 0.5) * s) for k in
              list(range(min(qmax, 20))) + [qmax - 1, qmax, qmax + 1]] + [
                  top, np.float32(0.0)]:
        out += [float(t), float(np.nextafter(t, np.float32(np.inf))),
                float(np.nextafter(t, np.float32(-np.inf)))]
    out += [_f32(v) for v in rng.uniform(-3 * qmax * s, 3 * qmax * s, 24)]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("qmax", [3, 15, 255])
def test_codes_equal_ieee_division(seed, qmax):
    """Over the fast range every code equals IEEE float32 division's, and
    the quotient is division's to the bit wherever the clamped a / s is
    at least 2^-3 (below, both give code 0)."""
    rng = np.random.default_rng(100 + seed)
    exact = 0
    for s in _scales(seed, 40 if qmax == 255 else 12):
        assert _fast(s), s
        for a in _values(s, qmax, rng):
            code, q = _kernel_code(a, s, qmax)
            assert code == _code(_ieee(a, s), qmax), (a, s, qmax)
            top = _mul(s, qmax)
            if 0 <= a <= top and _ieee(a, s) >= 2.0 ** -3:
                assert q == _ieee(a, s), (a, s, q)
                exact += 1
    assert exact > 100


def test_guard_sends_the_rest_to_division():
    """Outside [2^-100, 2^100], NaN, infinite, zero or subnormal scales and
    an fp16 scale divide: Markstein's steps leave the normal range there
    (RN(1 / s) is infinite, or subnormal). And the clamp is what keeps a
    huge a right, where q0 overflows and the correction makes NaN."""
    for s in (math.nan, math.inf, 0.0, 1e-40, LO / 2, HI * 2, 3e38):
        assert not _fast(s), s
    assert _fast(1.0) and not _fast(1.0, bf16=False)
    # unguarded, a subnormal scale's reciprocal overflows: q0 = inf and the
    # correction makes NaN (code 0), where division gives inf (code qmax)
    s, a = _f32(1e-40), 1.0
    assert math.isnan(_markstein(min(a, _mul(s, 255)), s))
    assert _kernel_code(a, s, 255) == (255, None)
    assert _code(_ieee(a, s), 255) == 255
    # unclamped, a / s overflows: q0 = inf, r = -inf, q = NaN (code 0),
    # where division gives inf (code qmax)
    s, a = _bf16(1e-12), 3e38
    assert math.isnan(_markstein(a, s))
    assert _kernel_code(a, s, 255)[0] == 255 == _code(_ieee(a, s), 255)


# ---------------------------------------------------------------------------
# every float32 significand of a, for whole bf16 significands of s
# ---------------------------------------------------------------------------

def _bitlen(n: np.ndarray) -> np.ndarray:
    ln = np.frexp(n.astype(np.float64))[1].astype(np.int64)
    return ln - (n < (np.int64(1) << np.maximum(ln - 1, 0)))


def _rne24(n: np.ndarray, sticky=None):
    """Positive integers n (plus a sticky fraction) to 24 significant bits,
    nearest even: (m, d) with the value m * 2^d."""
    d = np.maximum(_bitlen(n) - 24, 0)
    low = n & ((np.int64(1) << d) - 1)
    half = np.where(d > 0, np.int64(1) << np.maximum(d - 1, 0), 0)
    m = n >> d
    st = np.zeros(n.shape, bool) if sticky is None else sticky
    up = (d > 0) & ((low > half) | ((low == half) & (st | (m & 1 == 1))))
    return m + up, d


def _significand_mismatches(ms: int, step: int = 1 << 20) -> int:
    """For s = ms / 128 (ms in [128, 256): every bf16 significand) and
    a = ma / 2^23 for every ma in [2^23, 2^24): how many quotients of the
    reciprocal and Markstein's correction differ from RN(a / s). Every
    step is exact integer arithmetic with one rounding, as the hardware
    does it. Scaling a and s by powers of two scales every step's exact
    value alike while all stay normal, as group_div's guard and clamp
    ensure where the code depends on the quotient, so these pairs are
    every case there."""
    q, rem = divmod(1 << 31, ms)       # 1 / s = 2^31 / ms * 2^-24
    y = np.int64(q + (rem * 2 > ms or (rem * 2 == ms and q & 1)))
    bad = 0
    for lo in range(1 << 23, 1 << 24, step):
        ma = np.arange(lo, lo + step, dtype=np.int64)
        q0, d0 = _rne24(ma * y)                    # a * y = ma * y * 2^-47
        e = 47 - d0                                # q0 = q0 * 2^-e
        t = e + 7                                  # r = a - q0 * s, * 2^t
        r = (ma << (t - 23)) - q0 * ms
        rm, dr = _rne24(np.maximum(np.abs(r), 1))
        rm = np.where(r == 0, 0, rm) * np.sign(r)  # r = rm * 2^-(t - dr)
        t2 = t - dr + 24                           # q0 + r * y, * 2^t2
        qm, dq = _rne24((q0 << (t2 - e)) + rm * y)
        got = qm.astype(np.float64) * np.ldexp(1.0, dq - t2)
        p, rest = np.divmod(ma << 32, ms)          # a / s = p / 2^48
        wm, dw = _rne24(p, sticky=rest > 0)
        want = wm.astype(np.float64) * np.ldexp(1.0, dw - 48)
        bad += int((got != want).sum())
    return bad


@pytest.mark.parametrize("ms", [128, 129, 181, 254, 255])
def test_every_significand_of_a(ms):
    assert _significand_mismatches(ms) == 0


def test_the_sweep_sees_a_wrong_quotient():
    """The integer emulation finds the single product's errors: q0 alone
    differs from RN(a / s) for many a, so the sweep can fail."""
    ms, ma = 200, np.arange(1 << 23, (1 << 23) + 4096, dtype=np.int64)
    q, rem = divmod(1 << 31, ms)
    y = np.int64(q + (rem * 2 > ms or (rem * 2 == ms and q & 1)))
    q0, d0 = _rne24(ma * y)
    got = q0.astype(np.float64) * np.ldexp(1.0, d0 - 47)
    want = (ma.astype(np.float32) / np.float32(ms * 2.0 ** 16)).astype(
        np.float64)
    assert (got != want).sum() > 100


if __name__ == "__main__":
    total = 0
    for m in range(128, 256):
        total += _significand_mismatches(m)
    print(f"every bf16 significand x every float32 significand of a: "
          f"{total} quotients differ from RN(a / s)")
    sys.exit(1 if total else 0)
