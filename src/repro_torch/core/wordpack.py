"""Bit-plane pack/unpack: the codec's innermost loop.

Byte layout (shared with the JAX package, pinned by the golden wire
vectors): LSB-first within each byte, values packed in index order. Byte
``b`` of a ``unit``-bit plane holds values ``b*per .. b*per+per-1`` at bit
offsets ``0, unit, 2*unit, ...`` with ``per = 8 // unit``.

PyTorch on the CPU has no shifts on ``uint32``, so the lanes here are
``int32``: every value is below 2^8, and shifts of at most 7 bits keep
them far from the sign bit.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from repro_torch.core.comm_config import BIT_UNITS


def plane_nbytes(n: int, unit: int) -> int:
    """Wire bytes for one ``unit``-bit plane of ``n`` values (ceil)."""
    return (n * unit + 7) // 8


def pack_plane(field: torch.Tensor, unit: int) -> torch.Tensor:
    """(..., n) sub-byte values (< 2^unit) -> (..., ceil(n*unit/8)) uint8.

    A tail (n not a multiple of ``8 // unit``) is zero-padded.
    """
    if unit == 8:
        return field.to(torch.uint8)
    assert unit in (1, 2, 4), unit
    per = 8 // unit
    n = field.shape[-1]
    v = field.to(torch.int32)
    rem = (-n) % per
    if rem:
        v = torch.nn.functional.pad(v, (0, rem))
    v = v.reshape(*v.shape[:-1], -1, per)
    out = torch.zeros(v.shape[:-1], dtype=torch.int32, device=v.device)
    for j in range(per):
        out = out | (v[..., j] << (j * unit))
    return out.to(torch.uint8)


def unpack_plane(packed: torch.Tensor, unit: int, n: int) -> torch.Tensor:
    """(..., ceil(n*unit/8)) uint8 -> (..., n) uint8 plane values."""
    if unit == 8:
        return packed.to(torch.uint8)
    assert unit in (1, 2, 4), unit
    per = 8 // unit
    v = packed.to(torch.int32)
    mask = (1 << unit) - 1
    parts = [(v >> (j * unit)) & mask for j in range(per)]
    out = torch.stack(parts, dim=-1).reshape(*v.shape[:-1], -1)
    return out[..., :n].to(torch.uint8)


def pack_codes(codes: torch.Tensor, bits: int
               ) -> List[Tuple[int, torch.Tensor]]:
    """Split (..., n) codes into the bit-split planes of ``bits``, in wire
    order (regular part first, then the extra bit planes)."""
    planes = []
    shift = 0
    c = codes.to(torch.int32)
    for unit in BIT_UNITS[bits]:
        field = (c >> shift) & ((1 << unit) - 1)
        planes.append((unit, pack_plane(field, unit)))
        shift += unit
    return planes


def unpack_codes(read_plane: Callable[[int, int, int], torch.Tensor],
                 bits: int, n: int) -> torch.Tensor:
    """Rebuild (..., n) uint8 codes from the bit-split planes.

    ``read_plane(plane_index, unit, nbytes)`` returns the packed bytes of
    one plane.
    """
    out = None
    shift = 0
    for i, unit in enumerate(BIT_UNITS[bits]):
        vals = unpack_plane(read_plane(i, unit, plane_nbytes(n, unit)),
                            unit, n).to(torch.int32)
        contrib = (vals << shift) & 0xFF
        out = contrib if out is None else out | contrib
        shift += unit
    return out.to(torch.uint8)
