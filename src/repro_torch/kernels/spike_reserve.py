"""Spike reserving + RTN + bit-split pack: the CUDA kernel ``fc_spike_pack``.

Replaces the Pallas TPU kernel ``repro/kernels/spike_reserve.py:46
spike_pack``. The kernel (``csrc/stage.cu``) elects each group's spikes
by the rules of :mod:`repro_torch.core.spike`, quantizes the rest over the
shrunk range and packs, in one pass over the float tensor; its plain
version is :func:`repro_torch.kernels.ref.spike_pack_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitsplit
from repro_torch.kernels import stage


def spike_pack(x: torch.Tensor, bits: int, group: int):
    """(R, n) f32 or bf16 on the card -> (payload, scale, zero (R, G) bf16,
    spike_vals (R, G, 2) bf16, spike_idx (R, G, 2) int8)."""
    rows, n = x.shape
    stage.check_config("spike_pack", bits, group, n)
    stage.check_cuda(x, stage.IN_DTYPES, (rows, n), "spike_pack")
    g = n // group
    payload = torch.empty((rows, bitsplit.packed_nbytes(n, bits)),
                          dtype=torch.uint8, device=x.device)
    scale = torch.empty((rows, g), dtype=torch.bfloat16, device=x.device)
    zero = torch.empty_like(scale)
    spike_vals = torch.empty((rows, g, 2), dtype=torch.bfloat16,
                             device=x.device)
    spike_idx = torch.empty((rows, g, 2), dtype=torch.int8, device=x.device)
    stage.launch("spike_pack", x.device, x.data_ptr(), payload.data_ptr(),
                 scale.data_ptr(), zero.data_ptr(), spike_vals.data_ptr(),
                 spike_idx.data_ptr(), rows, n, bits, group,
                 int(x.dtype == torch.bfloat16))
    return payload, scale, zero, spike_vals, spike_idx
