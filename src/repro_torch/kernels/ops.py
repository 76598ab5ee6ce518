"""Backend dispatch for the codec kernels.

The wire codec: ``CommConfig.backend`` decides which implementation a
tensor goes through: ``"ref"`` the plain codec on any device, ``"cuda"``
the kernels (a CPU tensor raises), ``"auto"`` the kernels for a CUDA
tensor and the plain codec for a CPU one.

The per-stage kernels (``fused_quant_pack``, ``fused_dequant_unpack``,
``fused_spike_pack``, the JAX package's entry points of the same names)
take ``use_kernel``: ``None`` the kernel for a CUDA tensor and the plain
version for a CPU one, ``True`` the kernel (a CPU tensor raises),
``False`` the plain version. The kernels take any number of rows, so
there is no row padding.

The fused collectives (:func:`fused_all_reduce`, :func:`fused_all_to_all`)
go by their ``world`` argument: a
:class:`~repro_torch.kernels.rdma.PeerWorld` launches the peer-push
kernels; a process group or ``None`` runs the emulated schedule (the wire
kernels around the library hops), as the JAX package does off the TPU.

The CRC32C of the frame (:func:`crc32c_rows`) takes ``use_kernel`` as
the per-stage kernels do; the codec passes :func:`use_kernel` of the
frame's config, so that the ``"ref"`` backend stays plain on any device.

This is the only place that decides; the kernel wrappers take CUDA
tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (crc, dequant_unpack, quant_pack, rdma,
                                 ref, spike_reserve, wire)


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


def fused_all_reduce(x: torch.Tensor, cfg, world=None) -> torch.Tensor:
    """The fused two-step quantized AllReduce; ``n / tp`` a group
    multiple.

    ``world`` a :class:`~repro_torch.kernels.rdma.PeerWorld`: ``x`` is
    ``(local_ranks, n)`` (a loopback world) or this rank's ``(n,)`` (a
    world of processes), and the phase kernels run. A process group or
    ``None``: ``x`` is this rank's flat ``(n,)``, and the emulated schedule
    runs.
    """
    if isinstance(world, rdma.PeerWorld):
        return rdma.fused_all_reduce_rdma(x, cfg, world)
    from repro_torch.kernels import emulate    # emulate imports this module
    return emulate.fused_all_reduce_emulated(x, cfg, world)


def fused_all_to_all(x: torch.Tensor, cfg, world=None) -> torch.Tensor:
    """The fused quantized All2All; ``d`` a group multiple.

    ``world`` a :class:`~repro_torch.kernels.rdma.PeerWorld`: ``x`` is
    ``(world.local_ranks, tp, m, d)``, every local rank's blocks, and the
    peer-push kernel runs. A process group or ``None``: ``x`` is this
    rank's ``(tp, ..., d)`` blocks, and the emulated schedule runs (what
    the JAX package does for ``tp == 1`` and for ``axis_index_groups``).
    Block ``j`` of a rank's result is what rank ``j`` sent it.
    """
    if isinstance(world, rdma.PeerWorld):
        return rdma.fused_all_to_all_rdma(x, cfg, world)
    from repro_torch.kernels import emulate    # emulate imports this module
    return emulate.fused_all_to_all_emulated(x, cfg, world)


# ---------------------------------------------------------------------------
# per-stage kernels
# ---------------------------------------------------------------------------

def _stage_kernel(use_kernel, t: torch.Tensor) -> bool:
    """Whether ``use_kernel`` sends tensor ``t`` through a stage kernel."""
    if use_kernel is None:
        return t.device.type == "cuda"
    if use_kernel and t.device.type != "cuda":
        raise ValueError(f"use_kernel=True needs a CUDA tensor, got one on "
                         f"{t.device}")
    return bool(use_kernel)


def fused_quant_pack(x: torch.Tensor, bits: int, group: int,
                     use_kernel: bool | None = None):
    """(R, n) -> (payload, scale, zero)."""
    if _stage_kernel(use_kernel, x):
        return quant_pack.quant_pack(x.contiguous(), bits, group)
    return ref.quant_pack_ref(x, bits, group)


def fused_dequant_unpack(payload, scale, zero, bits: int, group: int,
                         n: int, out_dtype=torch.float32,
                         use_kernel: bool | None = None) -> torch.Tensor:
    """(payload, scale, zero) -> (R, n) ``out_dtype``."""
    if _stage_kernel(use_kernel, payload):
        return dequant_unpack.dequant_unpack(
            payload.contiguous(), scale.contiguous(), zero.contiguous(),
            bits, group, n, out_dtype)
    return ref.dequant_unpack_ref(payload, scale, zero, bits, group, n,
                                  out_dtype)


def fused_spike_pack(x: torch.Tensor, bits: int, group: int,
                     use_kernel: bool | None = None):
    """(R, n) -> (payload, scale, zero, spike_vals, spike_idx)."""
    if _stage_kernel(use_kernel, x):
        return spike_reserve.spike_pack(x.contiguous(), bits, group)
    return ref.spike_pack_ref(x, bits, group)


def crc32c_rows(rows: torch.Tensor, init: int = crc.MASK,
                use_kernel: bool | None = None) -> torch.Tensor:
    """(R, L) uint8 -> (R,) int64 CRC32C values, the bytes after a
    register ``init`` (0xFFFFFFFF: each row's plain CRC32C)."""
    if _stage_kernel(use_kernel, rows):
        return crc.crc32c_rows(rows, init)
    return crc.crc32c_rows_plain(rows, init)
