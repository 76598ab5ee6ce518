"""Full wire codec: tensor -> one contiguous uint8 buffer -> tensor.

For an input of shape ``(..., n)`` the encoder produces
``(..., wire_bytes(n))`` uint8 with the per-row byte layout::

    [bit-split packed codes | scales | zeros | spike vals | spike idx]

(paper Figs. 3 and 5c), byte for byte the JAX package's wire.

``CommConfig.backend`` picks the implementation:

* ``"ref"``  -- the plain PyTorch codec (:mod:`repro_torch.core.tilecodec`)
  on whatever device the tensor is on;
* ``"cuda"`` -- the CUDA kernels (:mod:`repro_torch.kernels.wire`); a CPU
  tensor raises;
* ``"auto"`` -- the kernels for a CUDA tensor, the plain codec for a CPU
  tensor.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.comm_config import CommConfig


def _check(cfg: CommConfig) -> None:
    assert cfg.enabled
    if cfg.framed:
        raise NotImplementedError(
            "framed wire (the JAX package's core/frame.py) is not ported")


def encode(x: torch.Tensor, cfg: CommConfig) -> torch.Tensor:
    """(..., n) float -> (..., cfg.wire_bytes(n)) uint8."""
    from repro_torch.kernels import ops    # deferred: kernels import core
    _check(cfg)
    n = x.shape[-1]
    buf = ops.fused_encode_wire(x.reshape(-1, n), cfg)
    return buf.reshape(*x.shape[:-1], buf.shape[-1])


def decode(buf: torch.Tensor, cfg: CommConfig, n: int,
           out_dtype=torch.float32) -> torch.Tensor:
    """(..., wire_bytes(n)) uint8 -> (..., n) out_dtype."""
    from repro_torch.kernels import ops
    _check(cfg)
    out = ops.fused_decode_wire(buf.reshape(-1, buf.shape[-1]), cfg, n,
                                out_dtype)
    return out.reshape(*buf.shape[:-1], n)


def qdq_wire(x: torch.Tensor, cfg: CommConfig) -> torch.Tensor:
    """Round-trip through the exact wire format (simulation helper)."""
    if not cfg.enabled:
        return x
    return decode(encode(x, cfg), cfg, x.shape[-1], out_dtype=x.dtype)


def wire_shape(shape: Tuple[int, ...], cfg: CommConfig) -> Tuple[int, ...]:
    return (*shape[:-1], cfg.wire_bytes(shape[-1]))
