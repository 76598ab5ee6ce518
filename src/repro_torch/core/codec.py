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

A framed config (``cfg.framed``, :mod:`repro_torch.core.frame`) encodes
the raw wire (``cfg.with_framed(False)``) and wraps each row in the
self-describing frame, the CRC32C through the kernel ``fc_crc32c`` where
the wire goes through the kernels. Its decode checks each row's header
and CRC on the device and NaN-poisons exactly the rows that fail, with no
host sync, as the JAX package does under ``jit``; a buffer whose width is
wrong for the config raises :class:`~repro_torch.core.frame.FrameError`
at once. (JAX's eager decode of a corrupt concrete buffer raises instead;
the port's host ingress that raises is :func:`repro_torch.core.frame.
frame_decode`.)
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import frame
from repro_torch.core.comm_config import CommConfig


def encode(x: torch.Tensor, cfg: CommConfig) -> torch.Tensor:
    """(..., n) float -> (..., cfg.wire_bytes(n)) uint8."""
    from repro_torch.kernels import ops    # deferred: kernels import core
    assert cfg.enabled
    n = x.shape[-1]
    if not cfg.framed:
        buf = ops.fused_encode_wire(x.reshape(-1, n), cfg)
    else:
        buf = frame.frame_wrap(ops.fused_encode_wire(
            x.reshape(-1, n), cfg.with_framed(False)), cfg)
    return buf.reshape(*x.shape[:-1], buf.shape[-1])


def decode(buf: torch.Tensor, cfg: CommConfig, n: int,
           out_dtype=torch.float32) -> torch.Tensor:
    """(..., wire_bytes(n)) uint8 -> (..., n) out_dtype; a framed row that
    fails its check decodes to NaN."""
    from repro_torch.kernels import ops
    assert cfg.enabled
    rows = buf.reshape(-1, buf.shape[-1])
    if not cfg.framed:
        out = ops.fused_decode_wire(rows, cfg, n, out_dtype)
        return out.reshape(*buf.shape[:-1], n)
    payload, ok = frame.frame_check_rows(rows, cfg, n)
    out = ops.fused_decode_wire(payload.contiguous(), cfg.with_framed(False),
                                n, out_dtype)
    out.masked_fill_(~ok[:, None], float("nan"))     # in place: no copy
    return out.reshape(*buf.shape[:-1], n)


def qdq_wire(x: torch.Tensor, cfg: CommConfig) -> torch.Tensor:
    """Round-trip through the exact wire format (simulation helper)."""
    if not cfg.enabled:
        return x
    return decode(encode(x, cfg), cfg, x.shape[-1], out_dtype=x.dtype)


def wire_shape(shape: Tuple[int, ...], cfg: CommConfig) -> Tuple[int, ...]:
    return (*shape[:-1], cfg.wire_bytes(shape[-1]))
