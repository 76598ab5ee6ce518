"""RTN quantize + bit-split pack: the CUDA kernel ``fc_quant_pack``.

Replaces the Pallas TPU kernel ``repro/kernels/quant_pack.py:54
quant_pack``. The kernel (``csrc/stage.cu``) reads the float tensor once
and writes only the packed planes and the bf16 scale and zero; its
plain version is :func:`repro_torch.kernels.ref.quant_pack_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitsplit
from repro_torch.kernels import stage


def quant_pack(x: torch.Tensor, bits: int, group: int):
    """(R, n) f32 or bf16 on the card -> (payload (R, packed_nbytes) u8,
    scale, zero (R, n/group) bf16)."""
    rows, n = x.shape
    stage.check_config("quant_pack", bits, group, n)
    stage.check_cuda(x, stage.IN_DTYPES, (rows, n), "quant_pack")
    payload = torch.empty((rows, bitsplit.packed_nbytes(n, bits)),
                          dtype=torch.uint8, device=x.device)
    scale = torch.empty((rows, n // group), dtype=torch.bfloat16,
                        device=x.device)
    zero = torch.empty_like(scale)
    stage.launch("quant_pack", x.device, x.data_ptr(), payload.data_ptr(),
                 scale.data_ptr(), zero.data_ptr(), rows, n, bits, group,
                 int(x.dtype == torch.bfloat16))
    return payload, scale, zero
