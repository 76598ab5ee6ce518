"""Backend dispatch for the wire codec.

``CommConfig.backend`` decides which implementation a tensor goes
through: ``"ref"`` the plain codec on any device, ``"cuda"`` the kernels
(a CPU tensor raises), ``"auto"`` the kernels for a CUDA tensor and the
plain codec for a CPU one. This is the only place that decides; the
kernel wrappers of :mod:`repro_torch.kernels.wire` take CUDA tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import wire


def use_kernel(cfg, t: torch.Tensor) -> bool:
    """Whether ``cfg.backend`` sends tensor ``t`` through the kernels."""
    if cfg.backend == "ref":
        return False
    if cfg.backend == "cuda" and t.device.type != "cuda":
        raise ValueError(f"codec backend 'cuda' needs a CUDA tensor, got "
                         f"one on {t.device}")
    return t.device.type == "cuda"


def fused_encode_wire(x: torch.Tensor, cfg) -> torch.Tensor:
    """(R, n) float -> (R, cfg.wire_bytes(n)) uint8."""
    if use_kernel(cfg, x):
        return wire.encode_wire(x.to(torch.float32).contiguous(), cfg)
    return wire.encode_plain(x, cfg)


def fused_decode_wire(buf: torch.Tensor, cfg, n: int,
                      out_dtype=torch.float32) -> torch.Tensor:
    """(R, cfg.wire_bytes(n)) uint8 -> (R, n) out_dtype."""
    if use_kernel(cfg, buf):
        return wire.decode_wire(buf.contiguous(), cfg, n, out_dtype)
    return wire.decode_plain(buf, cfg, n, out_dtype)


def fused_decode_reduce(buf: torch.Tensor, cfg, n: int) -> torch.Tensor:
    """(R, cfg.wire_bytes(n)) uint8 -> (1, n) f32 row sum."""
    if use_kernel(cfg, buf):
        return wire.decode_reduce(buf.contiguous(), cfg, n)
    return wire.decode_reduce_plain(buf, cfg, n)
