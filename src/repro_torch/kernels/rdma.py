"""The fused quantized All2All with the push inside the kernel.

One CUDA C++ kernel for Hopper (``csrc/rdma.cu`` ``fc_a2a``, device code
of the choreography in ``csrc/peer.cuh``) replaces the Pallas TPU kernel
``repro/kernels/rdma_all2all.py:75 fused_all_to_all_rdma`` (its kernel
``_a2a_kernel``, ``:56``): every rank encodes its ``tp`` per-peer blocks
straight into the peers' receive buffers, signals them, waits for theirs,
and decodes what it received into the payload dtype.

Bound on an H100: bytes. Per rank the payload is read once, the wire
written once and read once, and the output written once
(:func:`bound_bytes`). In the loopback world all of it is device memory
traffic at 3.35 TB/s; across cards the wire would cross NVLink instead.
What the design does about it: the wire is written once, by the encode,
into the peer's receive row (no send staging), and read once, by the
decode; a spin wait must never wait on a block that is not resident, so
the grid is persistent and launched cooperatively.

A :class:`PeerWorld` holds the ranks' receive buffers and signal pads,
sized from :func:`repro_torch.kernels.protocol.all2all_protocol`, and the
peer table the kernel pushes through. :meth:`PeerWorld.loopback` puts
``tp`` ranks on one card: their buffers are slices of one allocation, and
one cooperative launch runs every rank's copy of the kernel (the device
code a world of cards would run). A world of cards (one rank a device,
peer pointers from symmetric memory) is not built yet.

The wrapper takes CUDA tensors only and raises for anything else;
:func:`repro_torch.kernels.ops.fused_all_to_all` decides which path a
call takes. :func:`fused_all_to_all_rdma_plain` is the plain PyTorch
version. ``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import wire
from repro_torch.kernels.protocol import KernelProtocol, all2all_protocol

SOURCE = "rdma.cu"
MAX_PEERS = 16                    # csrc/peer.cuh kMaxPeers
_IN_KINDS = {torch.float32: 0, torch.bfloat16: 1}      # the model dtypes
_ALIGN = 256

#: launches of the kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"a2a": 0}


def reset_launches() -> None:
    LAUNCHES["a2a"] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load(SOURCE)
    lib.fc_a2a.argtypes = [ctypes.c_void_p] * 8
    lib.fc_a2a.restype = ctypes.c_int
    lib.fc_a2a_blocks_per_rank.argtypes = [ctypes.c_int]
    lib.fc_a2a_blocks_per_rank.restype = ctypes.c_int
    return lib


def signal_words(proto: KernelProtocol) -> int:
    """u32 counters of one rank's signal pad: the barrier, one for each
    receive slot, and the local slot (``csrc/peer.cuh``)."""
    return 1 + proto.sem_slots + 1


def _align(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


class PeerWorld:
    """The receive buffers and signal pads of ``tp`` ranks, and the table
    of peer pointers a kernel pushes through.

    ``local_ranks`` of the ranks, from ``rank0`` on, run in each launch.
    Rank ``r``'s receive buffer holds ``all2all_protocol(tp)``'s ``recv``
    rows (one for each sender) of ``row_bytes`` each; its signal pad
    holds :func:`signal_words` counters, zero at the start and only ever
    added to. ``epoch`` counts the calls made in the world.
    """

    def __init__(self, tp: int, local_ranks: int, rank0: int,
                 recv: List[int], signal: List[int], row_bytes: int,
                 storage: torch.Tensor):
        assert 1 <= tp <= MAX_PEERS, tp
        self.tp, self.local_ranks, self.rank0 = tp, local_ranks, rank0
        self.recv, self.signal = list(recv), list(signal)
        self.row_bytes = row_bytes
        self.storage = storage
        self.protocol = all2all_protocol(tp)
        self.epoch = 0
        self.blocks_per_rank: Optional[int] = None

    @classmethod
    def loopback(cls, tp: int, row_bytes: int, device="cuda") -> "PeerWorld":
        """``tp`` ranks on one device, in one zeroed allocation: the
        receive buffers, then the signal pads."""
        proto = all2all_protocol(tp)
        recv_stride = _align(proto.buffer("recv").rows * row_bytes)
        pad_stride = _align(4 * signal_words(proto))
        storage = torch.zeros(tp * (recv_stride + pad_stride),
                              dtype=torch.uint8, device=device)
        base = storage.data_ptr()
        recv = [base + r * recv_stride for r in range(tp)]
        signal = [base + tp * recv_stride + r * pad_stride
                  for r in range(tp)]
        return cls(tp, tp, 0, recv, signal, row_bytes, storage)

    def recv_rows(self, rank: int) -> torch.Tensor:
        """Rank ``rank``'s receive buffer, (recv rows, row_bytes) uint8
        (a loopback world's storage holds every rank's)."""
        rows = self.protocol.buffer("recv").rows
        off = self.recv[rank] - self.storage.data_ptr()
        return self.storage[off:off + rows * self.row_bytes].view(
            rows, self.row_bytes)

    def signal_pad(self, rank: int) -> torch.Tensor:
        """Rank ``rank``'s signal pad, (signal_words,) int32 view."""
        off = self.signal[rank] - self.storage.data_ptr()
        n = signal_words(self.protocol)
        return self.storage[off:off + 4 * n].view(torch.int32)

    def table(self, m: int, in_kind: int) -> np.ndarray:
        """The kernel's int64 peer argument (``csrc/rdma.cu`` fc_a2a)."""
        proto = self.protocol
        cols = np.zeros((5, MAX_PEERS), np.int64)
        cols[0, :self.tp] = self.recv
        cols[1, :self.tp] = self.signal
        offs = proto.barrier.signal_offsets
        cols[2, :len(offs)] = offs
        cols[3, :len(proto.pushes)] = [s.dst_off for s in proto.pushes]
        cols[4, :len(proto.pushes)] = [s.recv_slot for s in proto.pushes]
        head = [self.tp, self.local_ranks, self.rank0, m, self.row_bytes,
                self.epoch, self.blocks_per_rank or 0, in_kind,
                proto.sem_slots,
                len(offs), proto.barrier.wait_count, len(proto.pushes)]
        return np.concatenate([np.array(head, np.int64), cols.reshape(-1)])


def fused_all_to_all_rdma(x: torch.Tensor, cfg,
                          world: PeerWorld) -> torch.Tensor:
    """(local_ranks, tp, m, d) payload on the card -> the same shape and
    dtype: ``out[r][j]`` is what rank ``j`` sent rank ``r``, through the
    wire codec of ``cfg`` (``d`` a group multiple)."""
    wire._check_cfg(cfg)
    if x.dtype not in _IN_KINDS:
        raise TypeError(f"fused_all_to_all_rdma: unsupported dtype {x.dtype}")
    if (x.dim() != 4 or tuple(x.shape[:2]) != (world.local_ranks, world.tp)
            or not x.is_contiguous()):
        raise ValueError(f"fused_all_to_all_rdma: expected a contiguous "
                         f"({world.local_ranks}, {world.tp}, m, d) tensor, "
                         f"got {tuple(x.shape)}")
    _, tp, m, d = x.shape
    if d % cfg.group:
        raise ValueError(f"fused_all_to_all_rdma: d={d} is not a multiple "
                         f"of the group {cfg.group}")
    if x.device.type != "cuda":
        raise ValueError(f"fused_all_to_all_rdma: expected a CUDA tensor, "
                         f"got {x.device}")
    if x.device != world.storage.device:
        raise ValueError("fused_all_to_all_rdma: the payload and the world "
                         "are on different devices")
    if m * cfg.wire_bytes(d) > world.row_bytes:
        raise ValueError(f"fused_all_to_all_rdma: {m} rows of "
                         f"{cfg.wire_bytes(d)} wire bytes exceed the "
                         f"world's {world.row_bytes}-byte receive rows")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        if world.blocks_per_rank is None:
            bpr = _lib().fc_a2a_blocks_per_rank(world.local_ranks)
            if bpr < 1:
                raise RuntimeError(f"fc_a2a: no resident grid for "
                                   f"{world.local_ranks} ranks ({bpr})")
            world.blocks_per_rank = bpr
        if m * d == 0:
            return out
        world.epoch += 1
        a, thr, frac, f = wire._params(cfg, tp * m, d,
                                       wire._OUT_KINDS[x.dtype])
        peer = world.table(m, _IN_KINDS[x.dtype])
        rc = _lib().fc_a2a(x.data_ptr(), out.data_ptr(), a.ctypes.data,
                           thr.ctypes.data, frac.ctypes.data, f.ctypes.data,
                           peer.ctypes.data,
                           torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fc_a2a launch failed: CUDA error {rc}")
    LAUNCHES["a2a"] += 1
    return out


def fused_all_to_all_rdma_plain(x: torch.Tensor, cfg):
    """The plain version: (tp, tp, m, d) payload, every rank's blocks ->
    (out, recv): ``out`` as the kernel's, ``recv[r]`` rank ``r``'s
    received wire, (tp, tp, m * wire_bytes(d)) uint8 (row ``j`` from rank
    ``j``). A bf16 payload encodes as its exact float32 cast."""
    tp, tp2, m, d = x.shape
    assert tp == tp2, x.shape
    sent = wire.encode_plain(x.reshape(-1, d).to(torch.float32), cfg)
    wb = sent.shape[1]
    recv = sent.reshape(tp, tp, m, wb).transpose(0, 1).contiguous()
    out = wire.decode_plain(recv.reshape(-1, wb), cfg, d, x.dtype)
    return out.reshape(x.shape), recv.reshape(tp, tp, m * wb)


def bound_bytes(cfg, tp: int, m: int, d: int, itemsize: int) -> int:
    """Bytes the All2All must move over all ``tp`` ranks: each reads its
    payload and writes its wire once, then reads the wire it received and
    writes its output once."""
    return tp * tp * m * (2 * d * itemsize + 2 * cfg.wire_bytes(d))
