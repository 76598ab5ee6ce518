"""Bit splitting (paper Fig. 3): pack any-bit codes into dense uint8.

An irregular width splits into regular units: INT5 is a 4-bit part
(two values a byte) plus a 1-bit plane (eight a byte). The planes of a
row are stored one after another, regular part first, in one payload of
``sum(ceil(n * u / 8))`` bytes. The plane packing is
:mod:`repro_torch.core.wordpack`'s, byte for byte the JAX package's; a
tail (``n`` not a multiple of ``8 // unit``) is zero-padded on pack and
cut off on unpack.
"""
from __future__ import annotations

import torch

from repro_torch.core import wordpack
from repro_torch.core.comm_config import BIT_UNITS


def pack_unit(vals: torch.Tensor, unit: int) -> torch.Tensor:
    """(..., n) values below 2^unit -> (..., ceil(n*unit/8)) uint8."""
    return wordpack.pack_plane(vals, unit)


def unpack_unit(packed: torch.Tensor, unit: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_unit`; returns (..., n) uint8 values."""
    return wordpack.unpack_plane(packed, unit, n)


def pack(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., n) uint8 codes below 2^bits -> (..., packed_nbytes) uint8."""
    assert codes.dtype == torch.uint8, codes.dtype
    return torch.cat([p for _, p in wordpack.pack_codes(codes, bits)],
                     dim=-1)


def unpack(payload: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack`: (..., packed_nbytes) -> (..., n) codes."""
    assert payload.shape[-1] == packed_nbytes(n, bits), (payload.shape, n)
    offs, off = [], 0
    for unit in BIT_UNITS[bits]:
        offs.append(off)
        off += wordpack.plane_nbytes(n, unit)

    def read_plane(i, unit, nbytes):
        return payload[..., offs[i]:offs[i] + nbytes]

    return wordpack.unpack_codes(read_plane, bits, n)


def packed_nbytes(n: int, bits: int) -> int:
    return sum(wordpack.plane_nbytes(n, u) for u in BIT_UNITS[bits])
