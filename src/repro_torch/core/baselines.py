"""Comparison codecs from the paper's Table 3: Hadamard and LogFMT.

The port's copy of the JAX package's ``core/baselines.py``. Both are
QDQ simulators (the paper shows they collapse at INT2 where Spike
Reserving does not). They are not wired into the collectives: the paper
rejects them for communication on accuracy and cost grounds. Plain
tensor functions on any device; the JAX package has no kernel for them.

Against the JAX functions on the same float32 and bfloat16 inputs (bits
2-8, groups 32 and 128; ``tests/test_torch_baselines.py``), each output
within 2^-20 of the input's largest magnitude: ``hadamard_transform``
and ``hadamard_qdq`` measured bit-equal (the same butterflies in the same
order), ``logfmt_qdq`` at most 3.1e-7 of it apart (10698 values differ in
their last bits: PyTorch's ``log2`` / ``exp2`` and XLA's round
differently on the CPU).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.quant import group_reshape, group_unreshape, qdq

_EPS = 1e-12


def hadamard_transform(x: torch.Tensor) -> torch.Tensor:
    """Normalized fast Walsh-Hadamard transform along the last axis.

    Last axis must be a power of two (quant groups 32/128 are).
    Self-inverse under the 1/sqrt(n) normalization.
    """
    n = x.shape[-1]
    assert n & (n - 1) == 0, f"FWHT needs power-of-two size, got {n}"
    y = x.to(torch.float32)
    h = 1
    while h < n:
        y = y.reshape(*x.shape[:-1], n // (2 * h), 2, h)
        a = y[..., 0, :]
        b = y[..., 1, :]
        y = torch.cat([a + b, a - b], dim=-1)
        y = y.reshape(*x.shape[:-1], n)
        h *= 2
    # a full divisor tensor: PyTorch's CUDA division by a scalar
    # multiplies by its reciprocal, which is not IEEE division
    return y / torch.full_like(y, math.sqrt(float(n)))


def hadamard_qdq(x: torch.Tensor, bits: int, group: int) -> torch.Tensor:
    """Rotate each group, RTN-quantize, de-rotate (QuaRot-style)."""
    xg = group_reshape(x.to(torch.float32), group)
    rot = hadamard_transform(xg)
    flat = group_unreshape(rot)
    dq = qdq(flat, bits, group)
    back = hadamard_transform(group_reshape(dq, group))
    return group_unreshape(back).to(x.dtype)


def logfmt_qdq(x: torch.Tensor, bits: int, group: int) -> torch.Tensor:
    """LogFMT (DeepSeek-V3 insights): 1 sign bit + (bits-1)-bit log
    magnitude.

    Log-domain codes are RTN-quantized per group; dequantization
    exponentiates, which amplifies errors at low bit widths (the paper's
    point about why it fails at INT2).
    """
    assert bits >= 2
    xg = group_reshape(x.to(torch.float32), group)
    sign = torch.sign(xg)
    mag = torch.abs(xg)
    # Clamp zeros to the group's representable floor.
    floor = torch.clamp_min(torch.amax(mag, dim=-1, keepdim=True) * 1e-5,
                            _EPS)
    m = torch.log2(torch.maximum(mag, floor))
    mflat = group_unreshape(m)
    m_dq = group_reshape(qdq(mflat, bits - 1, group), group)
    y = sign * torch.exp2(m_dq)
    y = torch.where(mag < floor, torch.zeros_like(y), y)
    return group_unreshape(y).to(x.dtype)
