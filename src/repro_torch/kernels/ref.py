"""Plain PyTorch versions of the per-stage codec kernels.

Each composes the core modules as the JAX package's ``repro.kernels.ref``
does, on whatever device its inputs lie. They are what the CPU runs
(:mod:`repro_torch.kernels.ops` sends a CPU tensor here), what the tests
hold against the JAX package, and what ``chip_smoke.py`` holds the CUDA
kernels of :mod:`repro_torch.kernels.quant_pack`,
:mod:`~repro_torch.kernels.dequant_unpack` and
:mod:`~repro_torch.kernels.spike_reserve` against on the card. Meta
(scale, zero, spike values) is bf16, spike indices int8.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitsplit
from repro_torch.core.quant import dequantize, quantize
from repro_torch.core.spike import (SpikeQuant, spike_dequantize,
                                    spike_quantize)


def quant_pack_ref(x: torch.Tensor, bits: int, group: int):
    """(R, n) float -> (payload (R, packed_nbytes) u8, scale, zero
    (R, n/group) bf16)."""
    codes, scale, zero = quantize(x, bits, group)
    n = x.shape[-1]
    payload = bitsplit.pack(codes.reshape(*x.shape[:-1], n), bits)
    return payload, scale, zero


def dequant_unpack_ref(payload: torch.Tensor, scale: torch.Tensor,
                       zero: torch.Tensor, bits: int, group: int, n: int,
                       out_dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quant_pack_ref`: -> (R, n) ``out_dtype``."""
    codes = bitsplit.unpack(payload, bits, n)
    codes = codes.reshape(*payload.shape[:-1], n // group, group)
    return dequantize(codes, scale, zero, out_dtype)


def spike_pack_ref(x: torch.Tensor, bits: int, group: int):
    """(R, n) float -> (payload, scale, zero, spike_vals (R, G, 2) bf16,
    spike_idx (R, G, 2) int8)."""
    q = spike_quantize(x, bits, group)
    n = x.shape[-1]
    payload = bitsplit.pack(q.codes.reshape(*x.shape[:-1], n), bits)
    return payload, q.scale, q.zero, q.spike_vals, q.spike_idx


def spike_unpack_ref(payload, scale, zero, spike_vals, spike_idx,
                     bits: int, group: int, n: int,
                     out_dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`spike_pack_ref`: -> (R, n) ``out_dtype``."""
    codes = bitsplit.unpack(payload, bits, n)
    codes = codes.reshape(*payload.shape[:-1], n // group, group)
    return spike_dequantize(
        SpikeQuant(codes, scale, zero, spike_vals, spike_idx), out_dtype)
