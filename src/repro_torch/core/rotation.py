"""Randomized Hadamard rotation: the alternative to spike reserving.

Each group is rotated with ``x -> (x * s) @ H_g / sqrt(g)`` before
quantization and rotated back after dequantization. ``H_g`` is the
Sylvester-Hadamard matrix, ``H[i, j] = (-1)^popcount(i & j)``, and ``s``
a fixed ±1 vector from a stateless avalanche hash of the lane index,
seeded per group size, so both ends of the wire derive it alone.

The JAX package computes both directions as an f32 ``(g, g)`` matrix
product, whose summation order is XLA's. Here the order is fixed: output
``j`` is a sum over ``i`` in increasing order from +0.0, each product
rounded before it is added. The CUDA wire kernels
(``kernels/csrc/wire.cu``) sum in the same order, so they equal this
version bit for bit; against the JAX package a rotated value may differ
by rounding (see ``tests/test_torch_codec.py``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

#: seed for the fixed sign vectors; part of the wire format.
_SIGN_SEED = 20250809


def _check_group(group: int) -> None:
    assert group >= 1 and (group & (group - 1)) == 0, \
        f"rotation needs a power-of-two group, got {group}"


@functools.lru_cache(maxsize=None)
def _hadamard_np(group: int) -> np.ndarray:
    _check_group(group)
    i = np.arange(group, dtype=np.uint32)[:, None]
    j = np.arange(group, dtype=np.uint32)[None, :]
    par = np.vectorize(lambda v: bin(int(v)).count("1") & 1)(i & j)
    h = np.where(par == 1, np.float32(-1), np.float32(1))
    return h * hadamard_scale(group)


def sign_seed(group: int) -> int:
    """The seed of the sign hash for ``group`` (a uint32)."""
    return (_SIGN_SEED + group * 0x9E3779B9) & 0xFFFFFFFF


def hadamard_scale(group: int) -> np.float32:
    """The entries' magnitude ``1 / sqrt(group)``, rounded to f32."""
    return np.float32(1.0 / np.sqrt(group))


@functools.lru_cache(maxsize=None)
def _signs_np(group: int) -> np.ndarray:
    _check_group(group)
    u = (np.arange(group, dtype=np.uint64) + sign_seed(group)) & 0xFFFFFFFF
    u = ((u ^ (u >> 16)) * 0x7FEB352D) & 0xFFFFFFFF
    u = ((u ^ (u >> 15)) * 0x846CA68B) & 0xFFFFFFFF
    u = u ^ (u >> 16)
    return np.where((u & 1) == 1, np.float32(-1), np.float32(1))


def hadamard(group: int, device=None) -> torch.Tensor:
    """Orthonormal Sylvester-Hadamard matrix ``H / sqrt(group)`` (f32)."""
    return torch.from_numpy(_hadamard_np(group)).to(device)


def signs(group: int, device=None) -> torch.Tensor:
    """Fixed pseudo-random ±1 diagonal for ``group``-sized rotations."""
    return torch.from_numpy(_signs_np(group)).to(device)


def _ordered_matmul(xg: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """(..., g) @ (g, g) as ``sum_i xg[..., i] * h[i, :]``, i increasing,
    each product rounded before the add (no FMA, no reordering)."""
    acc = torch.zeros_like(xg)
    for i in range(xg.shape[-1]):
        acc = acc + xg[..., i:i + 1] * h[i]
    return acc


def rotate(x: torch.Tensor, group: int) -> torch.Tensor:
    """(..., n) -> (..., n) f32, each ``group``-chunk Hadamard-rotated."""
    shape = x.shape
    xg = x.to(torch.float32).reshape(*shape[:-1], -1, group)
    out = _ordered_matmul(xg * signs(group, x.device),
                          hadamard(group, x.device))
    return out.reshape(shape)


def unrotate(y: torch.Tensor, group: int) -> torch.Tensor:
    """Exact inverse of :func:`rotate` (orthogonal transpose)."""
    shape = y.shape
    yg = y.to(torch.float32).reshape(*shape[:-1], -1, group)
    out = _ordered_matmul(yg, hadamard(group, y.device).T) * signs(
        group, y.device)
    return out.reshape(shape)
