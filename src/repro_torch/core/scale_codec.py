"""Integer log2 scale/zero codec (paper Eq. 1): code = floor(log2(s)*theta).

Scales are positive and take an int8 code. Zeros (signed) take a
sign-magnitude byte: bit 7 the sign, bits 0..6 the biased log magnitude,
code 0 meaning exactly zero.

The codec is exponent arithmetic on the float32 bit pattern, with no
log2/exp2:

* encode: ``floor(log2(s) * theta) = e*theta + r`` where ``e`` is the
  unbiased exponent and ``r`` counts how many of the ``theta-1`` mantissa
  thresholds ``mant(2^(k/theta))`` the mantissa field reaches. The
  thresholds come from exact integer arithmetic, so the code equals the
  exact real floor for every float32 input.
* decode: ``2^(code/theta) = 2^q * T[r]`` with ``q, r = divmod(code,
  theta)`` and ``T`` the correctly rounded table of ``2^(r/theta)``.

NaN and inf carry biased exponent 255, so they clamp to the top code.
The tables are built here from integers; they equal the JAX package's.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

LOG_BIAS = 64
MAG_MIN = 1e-20
_MANT_BITS = 23
_MANT_ONE = 1 << _MANT_BITS


@functools.lru_cache(maxsize=None)
def mant_thresholds(theta: int) -> Tuple[int, ...]:
    """Smallest mantissa fields m_k with 1.m_k >= 2^(k/theta), k=1..theta-1.

    Exact: 2^(k/theta) is irrational for 0 < k < theta, so the integer
    comparison has no ties.
    """
    assert theta >= 2, f"theta={theta} (integer-log codec needs theta >= 2)"
    out = []
    for k in range(1, theta):
        m = max(int((2.0 ** (k / theta) - 1.0) * _MANT_ONE) - 2, 0)
        target = 1 << (_MANT_BITS * theta + k)
        while (_MANT_ONE + m) ** theta < target:
            m += 1
        out.append(m)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def frac_table(theta: int) -> Tuple[float, ...]:
    """Correctly rounded float32 values of 2^(r/theta), r = 0..theta-1."""
    vals = [1.0]
    thresholds = mant_thresholds(theta)
    for r in range(1, theta):
        m = thresholds[r - 1] - 1          # floor mantissa of 2^(r/theta)
        # round to nearest: is 2^(r/theta) above the half-ulp midpoint?
        mid = (1 << (_MANT_BITS + 1)) + 2 * m + 1
        if (1 << ((_MANT_BITS + 1) * theta + r)) > mid ** theta:
            m += 1
        vals.append(2.0 if m == _MANT_ONE else (_MANT_ONE + m) / _MANT_ONE)
    return tuple(vals)


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> its bit pattern as a non-negative int64."""
    return x.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & 0xFFFFFFFF


def floor_log2_theta(s: torch.Tensor, theta: int) -> torch.Tensor:
    """floor(log2(s) * theta) as int64, exact for positive normal s."""
    u = _f32_bits(s)
    e = (u >> _MANT_BITS) - 127
    mant = u & (_MANT_ONE - 1)
    r = torch.zeros_like(u)
    for m_k in mant_thresholds(theta):
        r = r + (mant >= m_k).to(torch.int64)
    return e * theta + r


def exp2_div_theta(v: torch.Tensor, theta: int) -> torch.Tensor:
    """Correctly rounded float32 of 2^(v/theta) for integer v >= -128."""
    off = -(-128 // theta) * theta          # multiple of theta, >= 128
    w = v.to(torch.int64) + off             # >= 0: floor div is plain
    q = w // theta - off // theta
    r = w - (w // theta) * theta
    pow2 = ((q + 127) << _MANT_BITS).to(torch.int32).view(torch.float32)
    frac = torch.ones_like(pow2)
    for k, t in enumerate(frac_table(theta)):
        frac = torch.where(r == k, t, frac)
    return frac * pow2                      # exact power-of-two scaling


def encode_scale(scale: torch.Tensor, theta: int = 10) -> torch.Tensor:
    """Positive scales -> int8 code floor(log2(s) * theta), clamped."""
    s = torch.clamp_min(scale.to(torch.float32), MAG_MIN)  # keeps NaN
    code = floor_log2_theta(s, theta)
    return torch.clamp(code, -128, 127).to(torch.int8)


def decode_scale(code: torch.Tensor, theta: int = 10) -> torch.Tensor:
    return exp2_div_theta(code.to(torch.int64), theta)


def encode_signed(x: torch.Tensor, theta: int = 10) -> torch.Tensor:
    """Signed values (zeros) -> uint8 sign-magnitude log code."""
    xf = x.to(torch.float32)
    sign = (xf < 0).to(torch.int64)
    mag = torch.clamp_min(torch.abs(xf), MAG_MIN)
    icode = floor_log2_theta(mag, theta) + LOG_BIAS
    code = torch.clamp(icode, 1, 127)
    code = torch.where(icode < 1, torch.zeros_like(code), code)
    return ((sign << 7) | code).to(torch.uint8)


def decode_signed(code: torch.Tensor, theta: int = 10) -> torch.Tensor:
    c = code.to(torch.int64)
    mag_code = c & 0x7F
    mag = exp2_div_theta(mag_code - LOG_BIAS, theta)
    mag = torch.where(mag_code == 0, torch.zeros_like(mag), mag)
    return torch.where((c >> 7) > 0, -mag, mag)
