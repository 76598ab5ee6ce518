"""The fused two-step AllReduce and the fused All2All, with the hop over
a process group, and the hops themselves.

The JAX package runs the codec phases of its fused collectives as kernels
and pushes wire rows to peers by RDMA from inside the kernel. Here the
phases are the CUDA kernels of :mod:`repro_torch.kernels.wire` and the hop
is ``torch.distributed`` on the uint8 wire (``all_to_all_single`` for the
scatter phase and the All2All, ``all_gather_into_tensor`` for the gather
phase). With one rank there is no hop: the wire rows a rank sends are the
rows it receives. (The collectives with the push inside the kernel are
:mod:`repro_torch.kernels.rdma`.)

A ``group`` here is a process group, or ``None`` for one rank. Over a
gloo group (ranks that share a card) a CUDA tensor is staged through
host memory: the hops copy it to the host, run the collective there, and
copy the result back (:func:`_staged`). An NCCL group takes the CUDA
tensor as it is.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.comm_config import CommConfig
from repro_torch.kernels import ops


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _staged(t: torch.Tensor, pg) -> bool:
    """Whether a hop of ``t`` over ``pg`` goes through host memory: a
    CUDA tensor over gloo."""
    return t.device.type == "cuda" and dist.get_backend(pg) == "gloo"


def all_to_all_rows(wire: torch.Tensor, group) -> torch.Tensor:
    """(tp, ...) rows -> (tp, ...): row p goes to peer p, row p of the
    result came from peer p."""
    if group_size(group) == 1:
        return wire
    if _staged(wire, group):
        return all_to_all_rows(wire.cpu(), group).to(wire.device)
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire.contiguous(), group=group)
    return out


def all_gather_rows(wire: torch.Tensor, group) -> torch.Tensor:
    """(...) -> (tp, ...): every rank's tensor, in rank order."""
    tp = group_size(group)
    if tp == 1:
        return wire[None]
    if _staged(wire, group):
        return all_gather_rows(wire.cpu(), group).to(wire.device)
    flat = wire.reshape(-1)             # gathered as a concatenation
    out = torch.empty((tp * flat.shape[0],), dtype=wire.dtype,
                      device=wire.device)
    dist.all_gather_into_tensor(out, flat.contiguous(), group=group)
    return out.reshape(tp, *wire.shape)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The exact sum of ``x`` over the ranks (a new tensor)."""
    if group_size(group) == 1:
        return x
    if _staged(x, group):
        return all_reduce_sum(x.cpu(), group).to(x.device)
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def encode_rows(x: torch.Tensor, cfg: CommConfig) -> torch.Tensor:
    """(R, chunk) float -> (R, wire_bytes(chunk)) uint8, one kernel pass:
    phase 1's quantize + pack and, with R == 1, phase 2's re-quantize."""
    return ops.fused_encode_wire(x, cfg)


def decode_reduce_rows(wire: torch.Tensor, cfg: CommConfig,
                       chunk: int) -> torch.Tensor:
    """(R, wb) uint8 -> (1, chunk) f32: fused dequantize + local reduce."""
    assert wire.shape == (wire.shape[0], cfg.wire_bytes(chunk))
    return ops.fused_decode_reduce(wire, cfg, chunk)


def decode_rows(wire: torch.Tensor, cfg: CommConfig, chunk: int,
                out_dtype=torch.float32) -> torch.Tensor:
    """(R, wb) uint8 -> (R, chunk): the receive-side dequantize."""
    assert wire.shape == (wire.shape[0], cfg.wire_bytes(chunk))
    return ops.fused_decode_wire(wire, cfg, chunk, out_dtype)


def fused_all_reduce_emulated(x: torch.Tensor, cfg: CommConfig,
                              group=None) -> torch.Tensor:
    """Flash two-step AllReduce of a flat (n,) vector, fused phases.

    Phase 1: one kernel encodes the tp per-peer chunks into wire rows,
    the rows go to their peers, one kernel dequantizes the received rows
    and sums them. Phase 2: the partial sum is re-encoded, gathered from
    every rank, and one kernel dequantizes all tp rows.
    """
    tp = group_size(group)
    n = x.shape[-1]
    assert n % tp == 0 and (n // tp) % cfg.group == 0, (n, tp, cfg.group)
    chunk = n // tp
    xc = x.reshape(tp, chunk).to(torch.float32)
    wire = encode_rows(xc, cfg)                              # (tp, wb)
    recv = all_to_all_rows(wire, group)                      # rows from peers
    partial = decode_reduce_rows(recv, cfg, chunk)           # (1, chunk)
    wire2 = encode_rows(partial, cfg)                        # (1, wb)
    allw = all_gather_rows(wire2[0], group)                  # (tp, wb)
    full = decode_rows(allw, cfg, chunk)                     # (tp, chunk)
    return full.reshape(n).to(x.dtype)


def fused_all_to_all_emulated(x: torch.Tensor, cfg: CommConfig,
                              group=None) -> torch.Tensor:
    """Fused quantized All2All of a (tp, ..., d) block tensor.

    One kernel encodes all ``tp * m`` payload rows (``d`` a group
    multiple: the collectives layer pads), block ``p`` goes to peer
    ``p``, and one kernel decodes the received rows straight into the
    payload dtype. Block ``j`` of the result is what peer ``j`` sent.
    """
    tp = group_size(group)
    assert x.shape[0] == tp, (x.shape, tp)
    d = x.shape[-1]
    assert d % cfg.group == 0, (d, cfg.group)
    rows = x.numel() // d
    wb = cfg.wire_bytes(d)
    wire = encode_rows(x.reshape(rows, d), cfg)              # (tp*m, wb)
    recv = all_to_all_rows(wire.reshape(tp, rows // tp, wb), group)
    out = decode_rows(recv.reshape(rows, wb), cfg, d, out_dtype=x.dtype)
    return out.reshape(x.shape)
