"""Bit-split unpack + dequantize: the CUDA kernel ``fc_dequant_unpack``.

Replaces the Pallas TPU kernel ``repro/kernels/dequant_unpack.py:42
dequant_unpack``. The kernel (``csrc/stage.cu``) rebuilds the codes from
their planes and writes ``codes * scale + zero`` (two roundings, as the
JAX package's eager reference does) in the output dtype once; its plain
version is :func:`repro_torch.kernels.ref.dequant_unpack_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitsplit
from repro_torch.kernels import stage


def dequant_unpack(payload: torch.Tensor, scale: torch.Tensor,
                   zero: torch.Tensor, bits: int, group: int, n: int,
                   out_dtype=torch.float32) -> torch.Tensor:
    """payload (R, packed_nbytes) u8, scale, zero (R, n/group) bf16 on the
    card -> (R, n) ``out_dtype`` (f32, bf16 or fp16)."""
    rows = payload.shape[0]
    stage.check_config("dequant_unpack", bits, group, n)
    stage.check_cuda(payload, (torch.uint8,),
                     (rows, bitsplit.packed_nbytes(n, bits)), "dequant_unpack")
    for t in (scale, zero):
        stage.check_cuda(t, (torch.bfloat16,), (rows, n // group),
                         "dequant_unpack", align=2)
    if out_dtype not in stage.OUT_KINDS:
        raise TypeError(f"dequant_unpack: unsupported out dtype {out_dtype}")
    out = torch.empty((rows, n), dtype=out_dtype, device=payload.device)
    stage.launch("dequant_unpack", payload.device, payload.data_ptr(),
                 scale.data_ptr(), zero.data_ptr(), out.data_ptr(), rows, n,
                 bits, group, stage.OUT_KINDS[out_dtype])
    return out
