"""Quantized AllReduce and All2All over a ``torch.distributed`` group.

The paper's Flash two-step AllReduce: chunk + quantize + all-to-all +
dequantize + local reduce, then re-quantize + all-gather + dequantize.
The wire that crosses the link is the uint8 buffer of
:mod:`repro_torch.core.codec`. A ``group`` is a process group, a
:class:`~repro_torch.parallel.axis.ModelAxis`, or ``None``: one rank, the
schedule run in full (both phases encode and decode), with no hop. This
module is where a group is taken apart: the kernel layer gets its process
group (the hops of :mod:`repro_torch.kernels.emulate`) or its peer world.

Schemes: ``"nccl"`` is the exact all-reduce; ``"two_step"`` runs the codec
around library collectives; ``"fused"`` runs the fused AllReduce of
:func:`repro_torch.kernels.ops.fused_all_reduce` on one flat vector: the
peer-push phase kernels through the axis's peer world when it has one,
else (on the CPU, or one rank) the fused phases around the library hops;
a CUDA tensor over more than one rank without a peer world raises. The
hierarchical schemes reduce to the two-step on one axis, as in the JAX
package; ``"hier_pp"`` feeds its microchunks through one batched
two-step.

The All2All (:func:`quantized_all_to_all`) quantizes the MoE dispatch
payload; the combine stays exact, as in the paper.
"""
from __future__ import annotations

import torch

from repro_torch.core import codec
from repro_torch.core.comm_config import CommConfig
from repro_torch.kernels import emulate, ops
from repro_torch.kernels.rdma import PeerWorld
from repro_torch.parallel.axis import axis_parts


def group_size(group) -> int:
    """The number of ranks of ``group``."""
    return emulate.group_size(axis_parts(group)[0])


def all_to_all_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Exact all-to-all of (tp, ...) rows: row p goes to peer p, row p of
    the result came from peer p."""
    return emulate.all_to_all_rows(x, axis_parts(group)[0])


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(...) -> (tp, ...): every rank's tensor, in rank order."""
    return emulate.all_gather_rows(x, axis_parts(group)[0])


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The exact sum of ``x`` over the ranks (a new tensor)."""
    return emulate.all_reduce_sum(x, axis_parts(group)[0])


def _fused_target(x: torch.Tensor, group, what: str):
    """Where a ``fused`` collective of ``x`` over ``group`` runs: the peer
    world, or the process group (``None``: one rank) of the emulated
    schedule. On the card more than one rank needs the world: the
    kernels are never bypassed for the host-staged hops."""
    pg, _, world = axis_parts(group)
    if world is not None:
        return world
    if x.device.type == "cuda" and emulate.group_size(pg) > 1:
        raise ValueError(f"fused {what} of a CUDA tensor over "
                         f"{emulate.group_size(pg)} ranks needs the model "
                         f"axis's peer world (repro_torch.launch.mesh."
                         f"init_model_axis)")
    return pg


def _pad_to(x: torch.Tensor, mult: int) -> torch.Tensor:
    rem = (-x.shape[-1]) % mult
    if rem == 0:
        return x
    return torch.nn.functional.pad(x, (0, rem))


def sum_rows(parts: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` in index order from +0.0, the order the fused
    decode-reduce kernel uses, so both schemes give equal bits."""
    acc = torch.zeros_like(parts.select(dim, 0))
    for r in range(parts.shape[dim]):
        acc = acc + parts.select(dim, r)
    return acc


def quantized_all_reduce(x: torch.Tensor, cfg: CommConfig,
                         group=None) -> torch.Tensor:
    """Flash two-step AllReduce of (..., n) vectors over ``group``.

    Leading dims batch through one schedule (one collective per phase).
    ``n`` must be a multiple of tp * group.
    """
    if cfg.scheme == "fused":
        out = ops.fused_all_reduce(x.reshape(-1), cfg,
                                   _fused_target(x, group, "AllReduce"))
        return out.reshape(x.shape).to(x.dtype)
    tp = group_size(group)
    n = x.shape[-1]
    lead = x.shape[:-1]
    b = len(lead)                                        # tp-axis position
    assert n % tp == 0 and (n // tp) % cfg.group == 0, (n, tp, cfg.group)
    xc = x.reshape(*lead, tp, n // tp)
    wire = codec.encode(xc, cfg)                         # (..., tp, w)
    recv = all_to_all_rows(wire.movedim(b, 0), group).movedim(0, b)
    parts = codec.decode(recv, cfg, n // tp)             # (..., tp, n/tp)
    partial = sum_rows(parts, b)                         # my chunk, summed
    wire2 = codec.encode(partial, cfg)                   # (..., w)
    allw = all_gather_rows(wire2, group).movedim(0, b)   # (..., tp, w)
    full = codec.decode(allw, cfg, n // tp)              # (..., tp, n/tp)
    return full.reshape(*lead, n).to(x.dtype)


def _flat_all_reduce(xf: torch.Tensor, cfg: CommConfig,
                     group=None) -> torch.Tensor:
    """Dispatch on scheme for a padded flat vector over one group.

    One axis has no (inner, outer) split, so "hierarchical" is the
    two-step itself and "hier_pp" batches its microchunks through one
    two-step schedule.
    """
    if cfg.scheme == "hier_pp":
        chunks = max(1, cfg.pipeline_chunks)
        out = quantized_all_reduce(xf.reshape(chunks, -1), cfg, group)
        return out.reshape(xf.shape)
    if cfg.scheme in ("two_step", "fused", "hierarchical"):
        return quantized_all_reduce(xf, cfg, group)
    raise ValueError(f"unknown scheme {cfg.scheme}")


def compressed_psum(x: torch.Tensor, cfg: CommConfig,
                    group=None) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``group`` with the compressed wire.

    Any shape: flattens, zero-pads to tp * group (* microchunks),
    casts to f32, runs the scheme, slices and restores shape and dtype.
    ``cfg.enabled`` false or scheme ``"nccl"`` is the exact all-reduce.
    """
    if not cfg.enabled or cfg.scheme == "nccl":
        return all_reduce_sum(x, group)
    chunks = cfg.pipeline_chunks if cfg.scheme == "hier_pp" else 1
    mult = group_size(group) * cfg.group * chunks
    n = x.numel()
    xf = _pad_to(x.reshape(-1), mult)
    out = _flat_all_reduce(xf.to(torch.float32), cfg, group)
    return out[:n].reshape(x.shape).to(x.dtype)


def quantized_all_to_all(x: torch.Tensor, cfg: CommConfig,
                         group=None) -> torch.Tensor:
    """Quantized All2All for MoE dispatch: ``x`` is (tp, ..., d), block
    ``p`` for peer ``p``; block ``j`` of the result came from peer ``j``.

    A last axis that is not a group multiple is zero-padded before encode
    and sliced back after decode. ``cfg.enabled`` false or scheme
    ``"nccl"`` is the exact all-to-all; ``"fused"`` runs
    :func:`repro_torch.kernels.ops.fused_all_to_all`; any other scheme
    runs the codec around a library all-to-all, decoding straight into
    the payload dtype.
    """
    if not cfg.enabled or cfg.scheme == "nccl":
        return all_to_all_rows(x, group)
    d = x.shape[-1]
    xp = _pad_to(x, cfg.group)
    if cfg.scheme == "fused":
        target = _fused_target(x, group, "All2All")
        if isinstance(target, PeerWorld):      # this rank's blocks, one rank
            out = ops.fused_all_to_all(
                xp.reshape(1, xp.shape[0], -1, xp.shape[-1]), cfg, target)
            return out.reshape(xp.shape)[..., :d]
        return ops.fused_all_to_all(xp, cfg, target)[..., :d]
    recv = all_to_all_rows(codec.encode(xp, cfg), group)
    return codec.decode(recv, cfg, xp.shape[-1], out_dtype=x.dtype)[..., :d]


def dispatch_all_to_all(x: torch.Tensor, cfg: CommConfig,
                        group=None) -> torch.Tensor:
    """The MoE dispatch All2All (quantized payload), forward only: the
    JAX package's backward, an exact all-to-all in the combine direction
    (straight-through quantization), comes with the training path."""
    return quantized_all_to_all(x, cfg, group)
