"""The plain PyTorch wire codec: ``(R, n) <-> (R, wire_bytes(n))`` tiles.

``encode_tile`` / ``decode_tile`` are the complete codec bodies, written
with tensor ops. They are the ``"ref"`` backend of :mod:`repro_torch.core.
codec`, the CPU path of every kernel wrapper in :mod:`repro_torch.kernels`
and the plain version each CUDA kernel is held against on the card.
Sections are written at the offsets of
:meth:`repro_torch.core.comm_config.CommConfig.wire_layout`.
"""
from __future__ import annotations

import torch

from repro_torch.core import rotation as rot
from repro_torch.core import scale_codec, wordpack
from repro_torch.core.comm_config import WireLayout, _wire_layout
from repro_torch.core.quant import (cast_out, dequantize, meta_dtype_of,
                                    quantize)
from repro_torch.core.spike import (SpikeQuant, spike_dequantize,
                                    spike_quantize)


def tile_layout(n: int, *, bits: int, group: int, spike: bool,
                scale_int: bool) -> WireLayout:
    """The wire layout for one (R, n) tile (cached static offsets)."""
    return _wire_layout(n, bits, group, spike, scale_int)


def tile_kwargs(cfg, n: int) -> dict:
    """The static keyword arguments of the tile bodies for one site."""
    return dict(bits=cfg.bits, group=cfg.group, n=n, spike=cfg.spike,
                rotation=cfg.rotation, scale_int=cfg.scale_int,
                theta=cfg.theta, meta_dtype=meta_dtype_of(cfg.meta_dtype))


def _meta_to_bytes(m: torch.Tensor) -> torch.Tensor:
    """(R, k) 2-byte meta dtype -> (R, 2k) uint8, little-endian pairs."""
    return m.contiguous().view(torch.uint8)


def _bytes_to_meta(b: torch.Tensor, dtype) -> torch.Tensor:
    """(R, 2k) uint8 -> (R, k) 2-byte meta dtype."""
    return b.contiguous().view(dtype)


def encode_sections(x: torch.Tensor, *, bits: int, group: int, n: int,
                    spike: bool, scale_int: bool, theta: int, meta_dtype,
                    rotation: bool = False):
    """(R, n) float tile -> [(Section, uint8 bytes), ...] in wire order."""
    assert x.shape[-1] == n, (x.shape, n)
    rows = x.shape[0]
    g = n // group
    layout = tile_layout(n, bits=bits, group=group, spike=spike,
                         scale_int=scale_int)
    if rotation:
        assert not spike
        x = rot.rotate(x, group)
    if spike:
        q = spike_quantize(x, bits, group, meta_dtype)
        codes, scale_w, zero_w = q.codes, q.scale, q.zero
    else:
        codes, scale_w, zero_w = quantize(x, bits, group, meta_dtype)
    codes = codes.reshape(rows, n)

    out = []
    for (unit, span), (u2, plane) in zip(
            layout.planes, wordpack.pack_codes(codes, bits)):
        assert unit == u2 and plane.shape[-1] == span.nbytes
        out.append((span, plane))                         # bit splitting
    if scale_int:                                         # paper Eq. 1
        out.append((layout.scale, scale_codec.encode_scale(
            scale_w, theta).view(torch.uint8)))
        out.append((layout.zero, scale_codec.encode_signed(zero_w, theta)))
    else:
        out.append((layout.scale, _meta_to_bytes(scale_w)))
        out.append((layout.zero, _meta_to_bytes(zero_w)))
    if spike:                                             # paper Fig. 5c
        out.append((layout.spike_vals,
                    _meta_to_bytes(q.spike_vals.reshape(rows, 2 * g))))
        si = q.spike_idx.reshape(rows, 2 * g)
        if scale_int:                                     # int8 indices
            out.append((layout.spike_idx, si.view(torch.uint8)))
        else:                                             # meta-width
            out.append((layout.spike_idx, _meta_to_bytes(
                si.to(meta_dtype_of(meta_dtype)))))
    return out


def encode_tile(x: torch.Tensor, *, bits: int, group: int, n: int,
                spike: bool, scale_int: bool, theta: int,
                meta_dtype, rotation: bool = False) -> torch.Tensor:
    """(R, n) float tile -> (R, wire_bytes(n)) uint8 wire tile."""
    layout = tile_layout(n, bits=bits, group=group, spike=spike,
                         scale_int=scale_int)
    buf = torch.empty((x.shape[0], layout.total), dtype=torch.uint8,
                      device=x.device)
    for span, sec in encode_sections(
            x, bits=bits, group=group, n=n, spike=spike,
            scale_int=scale_int, theta=theta, meta_dtype=meta_dtype,
            rotation=rotation):
        buf[:, span.offset:span.end] = sec
    return buf


def decode_tile(wire: torch.Tensor, *, bits: int, group: int, n: int,
                spike: bool, scale_int: bool, theta: int, meta_dtype,
                out_dtype, rotation: bool = False) -> torch.Tensor:
    """(R, wire_bytes(n)) uint8 wire tile -> (R, n) out_dtype tile."""
    rows = wire.shape[0]
    g = n // group
    meta_dtype = meta_dtype_of(meta_dtype)
    layout = tile_layout(n, bits=bits, group=group, spike=spike,
                         scale_int=scale_int)
    assert wire.shape[-1] == layout.total, (wire.shape, layout.total)

    def read_plane(i, unit, nbytes):
        span = layout.planes[i][1]
        assert span.nbytes == nbytes
        return wire[:, span.offset:span.end]

    codes = wordpack.unpack_codes(read_plane, bits, n)
    sb = wire[:, layout.scale.offset:layout.scale.end]
    zb = wire[:, layout.zero.offset:layout.zero.end]
    if scale_int:
        scale = scale_codec.decode_scale(sb.contiguous().view(torch.int8),
                                         theta)
        zero = scale_codec.decode_signed(zb, theta)
    else:
        scale = _bytes_to_meta(sb, meta_dtype)
        zero = _bytes_to_meta(zb, meta_dtype)

    codes = codes.reshape(rows, g, group)
    if spike:
        svb = wire[:, layout.spike_vals.offset:layout.spike_vals.end]
        sv = _bytes_to_meta(svb, meta_dtype)
        sib = wire[:, layout.spike_idx.offset:layout.spike_idx.end]
        if scale_int:
            si = sib.contiguous().view(torch.int8)
        else:
            si = _bytes_to_meta(sib, meta_dtype).to(torch.int8)
        q = SpikeQuant(codes, scale, zero,
                       sv.reshape(rows, g, 2), si.reshape(rows, g, 2))
        return spike_dequantize(q, out_dtype)
    if rotation:
        deq = dequantize(codes, scale, zero, torch.float32)
        return cast_out(rot.unrotate(deq, group), out_dtype)
    return dequantize(codes, scale, zero, out_dtype)
