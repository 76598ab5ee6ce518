"""Quantized collectives over ``torch.distributed`` groups, with the JAX
package's backward rules.

The paper's Flash two-step AllReduce: chunk + quantize + all-to-all +
dequantize + local reduce, then re-quantize + all-gather + dequantize.
The wire that crosses the link is the uint8 buffer of
:mod:`repro_torch.core.codec`. A ``group`` is a process group, a
:class:`~repro_torch.parallel.axis.ModelAxis` (any mesh axis: its process
group, the rank's index in it, and the peer world of its ``fused``
sites), or ``None``: one rank, the schedule run in full (both phases
encode and decode), with no hop. Where the JAX package takes a tuple of
mesh axes, the port takes a tuple (or list) of such groups, inner axis
first. This module is where a group is taken apart: the kernel layer gets
its process group (the hops of :mod:`repro_torch.kernels.emulate`) or its
peer world.

Schemes: ``"nccl"`` is the exact all-reduce; ``"two_step"`` runs the codec
around library collectives; ``"fused"`` runs the fused AllReduce of
:func:`repro_torch.kernels.ops.fused_all_reduce` on one flat vector: the
peer-push phase kernels through the axis's peer world when it has one
(a vector whose wire chunk exceeds the world's receive rows in pieces of
whole groups, which gives the same bits), else (on the CPU, or one rank)
the fused phases around the library hops; a CUDA tensor over more than
one rank without a peer world raises. On one axis the hierarchical
schemes reduce to the two-step (``"hier_pp"`` feeds its microchunks
through one batched two-step); over two axes they run the three-stage
schedule of :func:`hierarchical_all_reduce`.

Backward rules (``torch.autograd.Function`` where JAX has a
``custom_vjp``; quantization is straight-through everywhere):

===============================  ==========================================
forward                          backward
===============================  ==========================================
:func:`compressed_psum`          exact sum of the cotangent over the same
                                 axes, or ``compressed_psum`` under
                                 ``bwd_cfg`` (the ``tp_bwd`` site)
:func:`quantized_reduce_scatter` exact all-gather
:func:`quantized_all_gather`     exact reduce-scatter
:func:`compressed_psum_ef`,      as their plain counterparts; the residual
:func:`quantized_reduce_scatter  output is state and carries no gradient
_ef`
:func:`psum_exact`               exact sum (the transpose of ``psum`` under
                                 per-rank loss seeding)
:func:`dispatch_all_to_all`      exact all-to-all of the cotangent
:func:`all_to_all_rows`          exact all-to-all of the cotangent
:func:`all_gather_rows`          exact reduce-scatter, summed in rank order
===============================  ==========================================

The All2All (:func:`quantized_all_to_all`, under
:func:`dispatch_all_to_all`) quantizes the MoE dispatch payload; the
combine stays exact, as in the paper.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from repro_torch.core import codec
from repro_torch.core.comm_config import CommConfig
from repro_torch.kernels import emulate, ops
from repro_torch.kernels.rdma import PeerWorld
from repro_torch.parallel.axis import ModelAxis, axis_parts, axis_rank


def group_size(group) -> int:
    """The number of ranks of ``group``."""
    return emulate.group_size(axis_parts(group)[0])


class _AllToAllRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return emulate.all_to_all_rows(x, axis_parts(group)[0])

    @staticmethod
    def backward(ctx, g):
        return emulate.all_to_all_rows(g.contiguous(),
                                       axis_parts(ctx.group)[0]), None


def _differentiable(x: torch.Tensor, group) -> bool:
    """Whether a collective of ``x`` over ``group`` records a backward:
    autograd on, ``x`` needs a gradient, more than one rank."""
    return (torch.is_grad_enabled() and x.requires_grad
            and group_size(group) > 1)


def all_to_all_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Exact all-to-all of (tp, ...) rows: row p goes to peer p, row p of
    the result came from peer p. The backward is the all-to-all of the
    cotangent (tiled ``lax.all_to_all``'s transpose)."""
    if _differentiable(x, group):
        return _AllToAllRows.apply(x, group)
    return emulate.all_to_all_rows(x, axis_parts(group)[0])


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return emulate.all_gather_rows(x, axis_parts(group)[0])

    @staticmethod
    def backward(ctx, g):
        got = emulate.all_to_all_rows(g.contiguous(),
                                      axis_parts(ctx.group)[0])
        return sum_rows(got, 0), None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(...) -> (tp, ...): every rank's tensor, in rank order. The
    backward is the exact reduce-scatter of the cotangent (tiled
    ``lax.all_gather``'s transpose, ``psum_scatter``): each rank's row
    of every rank's cotangent, summed in rank order."""
    if _differentiable(x, group):
        return _AllGatherRows.apply(x, group)
    return emulate.all_gather_rows(x, axis_parts(group)[0])


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The exact sum of ``x`` over the ranks (a new tensor)."""
    return emulate.all_reduce_sum(x, axis_parts(group)[0])


def _as_axes(group) -> tuple:
    """A group, or a tuple / list of groups (inner axis first) -> tuple."""
    if isinstance(group, (tuple, list)) and not isinstance(group, ModelAxis):
        return tuple(group)
    return (group,)


def _sum_axes(x: torch.Tensor, axes) -> torch.Tensor:
    """The exact sum over every axis of ``axes`` in turn."""
    for ax in axes:
        x = all_reduce_sum(x, ax)
    return x


def all_gather_tiled(x: torch.Tensor, group) -> torch.Tensor:
    """(..., k) -> (..., tp * k): every rank's last axis, concatenated in
    rank order (a tiled all-gather)."""
    rows = all_gather_rows(x, group)                      # (tp, ..., k)
    return rows.movedim(0, -2).reshape(*x.shape[:-1], -1)


def reduce_scatter_tiled(x: torch.Tensor, group) -> torch.Tensor:
    """(..., n) -> (..., n / tp): this rank's chunk of the exact sum (a
    tiled reduce-scatter): chunk p goes to peer p in one all-to-all, and
    each rank sums the chunks it receives in rank order."""
    tp = group_size(group)
    if tp == 1:
        return x
    m = x.shape[-1] // tp
    rows = x.reshape(*x.shape[:-1], tp, m).movedim(-2, 0)  # (tp, ..., m)
    got = all_to_all_rows(rows.contiguous(), group)
    out = got[0].clone()
    for p in range(1, tp):
        out += got[p]
    return out


class _PsumExact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return _sum_axes(x, axes)

    @staticmethod
    def backward(ctx, g):
        return _sum_axes(g, ctx.axes), None


def psum_exact(x: torch.Tensor, group) -> torch.Tensor:
    """The exact sum over ``group`` (or a tuple of groups); its backward
    is the exact sum of the cotangent, ``lax.psum``'s transpose."""
    axes = _as_axes(group)
    if torch.is_grad_enabled() and x.requires_grad:
        return _PsumExact.apply(x, axes)
    return _sum_axes(x, axes)


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
                         f"{emulate.group_size(pg)} ranks needs the axis's "
                         f"peer world (repro_torch.launch.mesh)")
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


def _fused_all_reduce(flat: torch.Tensor, cfg: CommConfig,
                      target) -> torch.Tensor:
    """The fused AllReduce of a flat vector. Through a peer world whose
    receive rows cannot hold a wire chunk, in pieces of ``tp`` whole-group
    chunks that fit: every group is quantized on its own and every value
    summed in rank order, so the pieces give the bits of one call."""
    if isinstance(target, PeerWorld):
        tp, n = target.tp, flat.shape[0]
        if cfg.wire_bytes(n // tp) > target.row_bytes:
            piece = tp * cfg.group * (target.row_bytes
                                      // cfg.wire_bytes(cfg.group))
            assert piece > 0, (target.row_bytes, cfg)
            return torch.cat([
                ops.fused_all_reduce(flat[i:i + piece].contiguous(), cfg,
                                     target)
                for i in range(0, n, piece)])
    return ops.fused_all_reduce(flat, cfg, target)


def quantized_all_reduce(x: torch.Tensor, cfg: CommConfig,
                         group=None) -> torch.Tensor:
    """Flash two-step AllReduce of (..., n) vectors over ``group``.

    Leading dims batch through one schedule (one collective per phase).
    ``n`` must be a multiple of tp * group.
    """
    if cfg.scheme == "fused":
        out = _fused_all_reduce(x.reshape(-1), cfg,
                                _fused_target(x, group, "AllReduce"))
        return out.reshape(x.shape).to(x.dtype)
    tp = group_size(group)
    n = x.shape[-1]
    lead = x.shape[:-1]
    b = len(lead)                                        # tp-axis position
    assert n % tp == 0 and (n // tp) % cfg.group == 0, (n, tp, cfg.group)
    xc = x.reshape(*lead, tp, n // tp)
    wire = codec.encode(xc, cfg)                         # (..., tp, w)
    recv = all_to_all_rows(wire.movedim(b, 0).contiguous(),
                           group).movedim(0, b)
    parts = codec.decode(recv, cfg, n // tp)             # (..., tp, n/tp)
    partial = sum_rows(parts, b)                         # my chunk, summed
    del wire, recv, parts
    wire2 = codec.encode(partial, cfg)                   # (..., w)
    allw = all_gather_rows(wire2, group).movedim(0, b)   # (..., tp, w)
    full = codec.decode(allw, cfg, n // tp)              # (..., tp, n/tp)
    return full.reshape(*lead, n).to(x.dtype)


def _qrs(x: torch.Tensor, cfg: CommConfig, group):
    """The quantized reduce-scatter -> (this rank's summed chunk, the
    group-padded (..., tp, m) chunks it encoded, their wire)."""
    tp = group_size(group)
    n = x.shape[-1]
    lead = x.shape[:-1]
    b = len(lead)
    assert n % tp == 0, (n, tp)
    m = n // tp
    xc = _pad_to(x.reshape(*lead, tp, m), cfg.group)
    wire = codec.encode(xc, cfg)
    recv = all_to_all_rows(wire.movedim(b, 0).contiguous(),
                           group).movedim(0, b)
    parts = codec.decode(recv, cfg, xc.shape[-1])
    del recv
    out = sum_rows(parts, b)[..., :m].to(x.dtype)
    return out, xc, wire


class _QuantizedReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cfg, group):
        ctx.group = group
        return _qrs(x, cfg, group)[0]

    @staticmethod
    def backward(ctx, g):
        return all_gather_tiled(g, ctx.group), None, None


def quantized_reduce_scatter(x: torch.Tensor, cfg: CommConfig,
                             group=None) -> torch.Tensor:
    """Quantized RS: (..., n) -> (..., n / tp), this rank's summed chunk
    (phase 1 of the two-step); leading dims batch through one collective.

    Chunks are padded to the group size, the pad sliced off after the
    summed decode, so any ``n % tp == 0`` compresses. The backward is the
    exact all-gather of the cotangent, the true transpose.
    """
    if torch.is_grad_enabled() and x.requires_grad:
        return _QuantizedReduceScatter.apply(x, cfg, group)
    return _qrs(x, cfg, group)[0]


def _qag(x: torch.Tensor, cfg: CommConfig, group) -> torch.Tensor:
    n = x.shape[-1]
    lead = x.shape[:-1]
    b = len(lead)
    assert n % cfg.group == 0, (n, cfg.group)
    wire = codec.encode(x, cfg)
    allw = all_gather_rows(wire, group).movedim(0, b)    # (..., tp, w)
    full = codec.decode(allw, cfg, n)                    # (..., tp, k)
    return full.reshape(*lead, -1).to(x.dtype)


class _QuantizedAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cfg, group):
        ctx.group = group
        return _qag(x, cfg, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_tiled(g, ctx.group), None, None


def quantized_all_gather(x: torch.Tensor, cfg: CommConfig,
                         group=None) -> torch.Tensor:
    """Quantized AG: (..., k) -> (..., tp * k), ``k`` a group multiple
    (the ZeRO++-style weight gather); leading dims batch through one
    collective. The backward is the exact reduce-scatter."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _QuantizedAllGather.apply(x, cfg, group)
    return _qag(x, cfg, group)


# ---------------------------------------------------------------------------
# hierarchical schemes (inner = the fast axis, outer = the slow bridge)
# ---------------------------------------------------------------------------

def hierarchical_all_reduce(x: torch.Tensor, inner, outer, cfg: CommConfig,
                            outer_cfg: Optional[CommConfig] = None
                            ) -> torch.Tensor:
    """Three-stage hierarchical AllReduce (the paper's Figs. 6-7): a
    quantized reduce-scatter inside the inner axis, an AllReduce of the
    scattered partial sums across the outer axis (only n / inner values
    cross it), a quantized all-gather inside the inner axis. ``outer_cfg``
    (default ``cfg``) is the outer hop's wire. Leading dims batch."""
    outer_cfg = outer_cfg or cfg
    n_in = group_size(inner)
    n = x.shape[-1]
    b = x.dim() - 1
    assert n % n_in == 0 and (n // n_in) % cfg.group == 0, (n, n_in)
    chunk = _qrs(x, cfg, inner)[0]                       # (..., n/inner)
    n_out = group_size(outer)
    if n_out > 1:
        if (n // n_in) % (n_out * outer_cfg.group) == 0:
            chunk = quantized_all_reduce(chunk, outer_cfg, outer)
        else:          # small remainder chunks: quantized AG + local sum
            wire = codec.encode(chunk, outer_cfg)
            allw = all_gather_rows(wire, outer).movedim(0, b)
            chunk = sum_rows(codec.decode(allw, outer_cfg, chunk.shape[-1]),
                             b).to(x.dtype)
    return _qag(chunk, cfg, inner).to(x.dtype)


def pipelined_hierarchical_all_reduce(x: torch.Tensor, inner, outer,
                                      cfg: CommConfig,
                                      outer_cfg: Optional[CommConfig] = None
                                      ) -> torch.Tensor:
    """The hierarchical AllReduce of a flat vector cut into
    ``cfg.pipeline_chunks`` microchunks, all run through one schedule as a
    (chunks, n / chunks) batch (the paper's Fig. 8)."""
    chunks = max(1, cfg.pipeline_chunks)
    n = x.shape[-1]
    mult = group_size(inner) * cfg.group * chunks
    assert n % mult == 0, (n, mult)
    out = hierarchical_all_reduce(x.reshape(chunks, n // chunks), inner,
                                  outer, cfg, outer_cfg)
    return out.reshape(n)


def _flat_all_reduce(xf: torch.Tensor, axes, cfg: CommConfig,
                     outer_cfg: Optional[CommConfig] = None) -> torch.Tensor:
    """Dispatch on scheme for a padded flat vector over ``axes``.

    One axis has no (inner, outer) split: "hierarchical" is the two-step
    itself, "hier_pp" batches its microchunks through one two-step, and
    the lone axis is the bridge, so ``outer_cfg`` (when given) is the wire
    that runs. Two axes: "two_step" and "fused" run one two-step an axis
    in turn (``outer_cfg`` on the last), the hierarchical schemes their
    three-stage schedule.
    """
    if len(axes) == 1:
        hop = outer_cfg or cfg
        if cfg.scheme == "hier_pp":
            chunks = max(1, cfg.pipeline_chunks)
            out = quantized_all_reduce(xf.reshape(chunks, -1), hop, axes[0])
            return out.reshape(xf.shape)
        if cfg.scheme in ("two_step", "fused", "hierarchical"):
            return quantized_all_reduce(xf, hop, axes[0])
        raise ValueError(f"unknown scheme {cfg.scheme}")
    if cfg.scheme in ("two_step", "fused"):
        out = xf
        for i, ax in enumerate(axes):
            hop = outer_cfg if (outer_cfg is not None
                                and i == len(axes) - 1) else cfg
            out = quantized_all_reduce(out, hop, ax)
        return out
    inner, outer = axes
    if cfg.scheme == "hierarchical":
        return hierarchical_all_reduce(xf, inner, outer, cfg, outer_cfg)
    if cfg.scheme == "hier_pp":
        return pipelined_hierarchical_all_reduce(xf, inner, outer, cfg,
                                                 outer_cfg)
    raise ValueError(f"unknown scheme {cfg.scheme}")


def _group_mult(cfg: CommConfig, outer_cfg: Optional[CommConfig]) -> int:
    """Group granularity both tiers' wire formats align on."""
    if outer_cfg is None or not outer_cfg.enabled:
        return cfg.group
    return math.lcm(cfg.group, outer_cfg.group)


def _psum(x: torch.Tensor, axes, cfg: CommConfig,
          outer_cfg: Optional[CommConfig] = None) -> torch.Tensor:
    """compressed_psum's forward."""
    if not cfg.enabled or cfg.scheme == "nccl":
        return _sum_axes(x, axes)
    chunks = cfg.pipeline_chunks if cfg.scheme == "hier_pp" else 1
    mult = _group_mult(cfg, outer_cfg) * chunks
    for ax in axes:
        mult *= group_size(ax)
    n = x.numel()
    xf = _pad_to(x.reshape(-1), mult)
    out = _flat_all_reduce(xf.to(torch.float32), axes, cfg, outer_cfg)
    return out[:n].reshape(x.shape).to(x.dtype)


class _CompressedPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, cfg, bwd_cfg, outer_cfg):
        ctx.axes, ctx.bwd_cfg = axes, bwd_cfg
        return _psum(x, axes, cfg, outer_cfg)

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd_cfg is not None and ctx.bwd_cfg.enabled:
            out = _psum(g, ctx.axes, ctx.bwd_cfg)
        else:
            out = _sum_axes(g, ctx.axes)
        return out, None, None, None, None


def compressed_psum(x: torch.Tensor, cfg: CommConfig, group=None,
                    bwd_cfg: Optional[CommConfig] = None,
                    outer_cfg: Optional[CommConfig] = None) -> torch.Tensor:
    """Sum of ``x`` over ``group`` (or a tuple of groups, inner first)
    with the compressed wire.

    Any shape: flattens, zero-pads to the chunking granularity (every
    axis's size x the group, the lcm of both tiers' groups with
    ``outer_cfg``, x microchunks), casts to f32, runs the scheme, slices
    and restores shape and dtype. ``cfg.enabled`` false or scheme
    ``"nccl"`` is the exact sum. ``outer_cfg`` is the wire of the bridge
    tier (the last axis).

    The backward is the exact sum of the cotangent over the same axes, or
    ``compressed_psum`` under ``bwd_cfg`` when it is enabled (the
    ``tp_bwd`` site), whatever the forward ran.
    """
    axes = _as_axes(group)
    if torch.is_grad_enabled() and x.requires_grad:
        return _CompressedPsum.apply(x, axes, cfg, bwd_cfg, outer_cfg)
    return _psum(x, axes, cfg, outer_cfg)


# ---------------------------------------------------------------------------
# error-feedback (EF21-style) compressed collectives
# ---------------------------------------------------------------------------

def _local_qdq_error(xe_flat: torch.Tensor, cfg: CommConfig,
                     mult: int) -> torch.Tensor:
    """This rank's phase-1 quantization error of a flat vector: the group
    boundaries of a flat QDQ over the collective's padding are the ones
    its first quantization used."""
    xp = _pad_to(xe_flat, mult)
    err = xp - codec.qdq_wire(xp, cfg)
    return err[:xe_flat.shape[0]]


def _ef_two_step(xe_flat: torch.Tensor, group, cfg: CommConfig):
    """Single-axis two-step AllReduce of a padded flat vector with its
    whole error captured: ``xe -> (out, residual)``.

    The residual is this rank's phase-1 error on every chunk plus, at the
    chunk this rank owns, the phase-2 error of its re-quantized partial
    sum, so the residuals of all ranks sum to the AllReduce's entire
    error. Leading dims batch (the hier_pp microchunks).

    ``xe_flat`` is the caller's own temporary and is overwritten: the
    residual is built in its storage (a gradient leaf of 525 M values
    needs every gigabyte the card has).
    """
    tp = group_size(group)
    lead = xe_flat.shape[:-1]
    b = len(lead)
    m = xe_flat.shape[-1]
    xc = xe_flat.reshape(*lead, tp, m // tp)
    wire = codec.encode(xc, cfg)
    err1 = xc.sub_(codec.decode(wire, cfg, m // tp))     # phase 1, mine
    recv = all_to_all_rows(wire.movedim(b, 0).contiguous(),
                           group).movedim(0, b)
    del wire
    parts = codec.decode(recv, cfg, m // tp)
    del recv
    partial = sum_rows(parts, b)                         # my chunk's sum
    del parts
    wire2 = codec.encode(partial, cfg)
    err2 = partial - codec.decode(wire2, cfg, m // tp)   # phase 2, mine
    del partial
    allw = all_gather_rows(wire2, group).movedim(0, b)
    out = codec.decode(allw, cfg, m // tp).reshape(*lead, m)
    del allw
    # err1 + own * err2 (own: this rank's chunk 1, the others 0), a chunk
    # at a time in place
    own = (torch.arange(tp, device=xe_flat.device)
           == axis_rank(group)).to(torch.float32)
    for c in range(tp):
        err1.select(b, c).add_(own[c] * err2)
    return out, err1.reshape(*lead, m)


def _psum_ef(x: torch.Tensor, residual: torch.Tensor, axes,
             cfg: CommConfig):
    """compressed_psum_ef's forward."""
    if not cfg.enabled or cfg.scheme == "nccl":
        return _sum_axes(x, axes), residual
    shape, n = x.shape, x.numel()
    xe = x.to(torch.float32) + residual.to(torch.float32)
    chunks = cfg.pipeline_chunks if cfg.scheme == "hier_pp" else 1
    if len(axes) == 1 and cfg.scheme in ("two_step", "hierarchical",
                                         "hier_pp"):
        tp = group_size(axes[0])
        xf = _pad_to(xe.reshape(-1), tp * cfg.group * chunks)
        del xe
        if chunks > 1:          # hier_pp: batched microchunk pipeline
            xf = xf.reshape(chunks, xf.shape[0] // chunks)
        out, res = _ef_two_step(xf, axes[0], cfg)
        return (out.reshape(-1)[:n].reshape(shape).to(x.dtype),
                res.reshape(-1)[:n].reshape(shape).to(residual.dtype))
    out = _psum(xe, axes, cfg)
    mult = cfg.group * chunks
    for ax in axes:
        mult *= group_size(ax)
    new_res = _local_qdq_error(xe.reshape(-1), cfg, mult).reshape(shape)
    return out.to(x.dtype), new_res.to(residual.dtype)


class _CompressedPsumEF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, axes, cfg):
        ctx.axes = axes
        return _psum_ef(x, residual, axes, cfg)

    @staticmethod
    def backward(ctx, g_out, g_res):
        # straight-through: out = psum(x + r); the residual x + r -
        # QDQ(x + r) has a zero straight-through Jacobian
        out = _sum_axes(g_out, ctx.axes)
        return out, out, None, None


def compressed_psum_ef(x: torch.Tensor, residual: torch.Tensor,
                       cfg: CommConfig, group=None):
    """Error-feedback ``compressed_psum``: ``(x, residual_in) -> (out,
    residual_out)``.

    Adds the previous step's error back in (``xe = x + residual``), runs
    the quantized AllReduce of ``xe`` and returns the error the wire
    dropped. On one axis with the two-step schedules the residual holds
    both quantization stages (:func:`_ef_two_step`); on several axes, or
    ``fused``, the phase-1 error of this rank (its local QDQ error).
    Disabled (or ``"nccl"``): the exact sum, the residual passed through.
    """
    axes = _as_axes(group)
    if torch.is_grad_enabled() and (x.requires_grad
                                    or residual.requires_grad):
        return _CompressedPsumEF.apply(x, residual, axes, cfg)
    return _psum_ef(x, residual, axes, cfg)


def _qrs_ef(x: torch.Tensor, residual: torch.Tensor, cfg: CommConfig,
            group):
    if not cfg.enabled or cfg.scheme == "nccl":
        return reduce_scatter_tiled(x, group), residual
    tp = group_size(group)
    m = x.shape[-1] // tp
    xe = x.to(torch.float32) + residual.to(torch.float32)
    out, xc, wire = _qrs(xe, cfg, group)
    # the RS quantizes once: this rank's whole error is its QDQ error on
    # the chunked, group-padded view the RS encoded (the same wire)
    err = (xc - codec.decode(wire, cfg, xc.shape[-1]))[..., :m]
    return out.to(x.dtype), err.reshape(xe.shape).to(residual.dtype)


class _QuantizedReduceScatterEF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, cfg, group):
        ctx.group = group
        return _qrs_ef(x, residual, cfg, group)

    @staticmethod
    def backward(ctx, g_out, g_res):
        ag = all_gather_tiled(g_out, ctx.group)
        return ag, ag, None, None


def quantized_reduce_scatter_ef(x: torch.Tensor, residual: torch.Tensor,
                                cfg: CommConfig, group=None):
    """Error-feedback quantized RS: ``(x (..., n), residual (..., n)) ->
    (chunk (..., n / tp), residual_out (..., n))``: the residual lives at
    the input's shape. Disabled (or ``"nccl"``): the exact reduce-scatter,
    the residual passed through."""
    if torch.is_grad_enabled() and (x.requires_grad
                                    or residual.requires_grad):
        return _QuantizedReduceScatterEF.apply(x, residual, cfg, group)
    return _qrs_ef(x, residual, cfg, group)


def grad_all_reduce(grads: Dict, axes: Sequence, cfg: CommConfig,
                    mean: bool = True,
                    outer_cfg: Optional[CommConfig] = None) -> Dict:
    """Gradient sync of a nested dict of tensors over ``axes`` (data[,
    pod] groups, inner first): ``compressed_psum`` of every leaf (the last
    axis at ``outer_cfg``), over the axes' total size when ``mean``."""
    axes = tuple(axes)
    denom = 1
    for ax in axes:
        denom *= group_size(ax)

    def one(g):
        if isinstance(g, dict):
            return {k: one(v) for k, v in g.items()}
        out = compressed_psum(g, cfg, axes, None, outer_cfg)
        return out / denom if mean else out

    return one(grads)


# ---------------------------------------------------------------------------
# MoE dispatch
# ---------------------------------------------------------------------------

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


class _DispatchAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cfg, group):
        ctx.group = group
        return quantized_all_to_all(x, cfg, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_rows(g.contiguous(), ctx.group), None, None


def dispatch_all_to_all(x: torch.Tensor, cfg: CommConfig,
                        group=None) -> torch.Tensor:
    """The MoE dispatch All2All: :func:`quantized_all_to_all` of (tp, ...,
    d) blocks. The backward is the exact all-to-all of the cotangent (the
    combine direction): the dispatch's quantization is straight-through,
    as the JAX package's ``custom_vjp``."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _DispatchAllToAll.apply(x, cfg, group)
    return quantized_all_to_all(x, cfg, group)
