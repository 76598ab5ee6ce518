"""The peer-push collectives: the fused quantized All2All and the fused
two-step quantized AllReduce, with the push inside the kernels.

Hand-written CUDA C++ kernels for Hopper (device code of the choreography
in ``csrc/peer.cuh``) replace the Pallas TPU kernels:

* :func:`fused_all_to_all_rdma`: ``csrc/rdma.cu`` ``fc_a2a``, for
  ``repro/kernels/rdma_all2all.py:75 fused_all_to_all_rdma``
  (``_a2a_kernel``);
* :func:`fused_all_reduce_rdma`: ``csrc/allreduce.cu`` ``fc_ar``, for
  ``repro/kernels/rdma_allreduce.py:154 fused_all_reduce_rdma``
  (``_scatter_reduce_kernel`` and ``_gather_kernel``, both phases in one
  launch).

Each rank encodes what it sends straight into its peers' receive
buffers, signals them, waits for theirs, and decodes what it received
(the AllReduce: phase 1 sums the decoded rows of the rank's chunk, and
the same threads quantize the sum and push its wire bytes to every peer
for phase 2).

Bound on an H100: bytes (:func:`bound_bytes`, :func:`bound_bytes_ar`).
On one card all of it is device memory traffic at 3.35 TB/s; across
cards the pushed wire would cross NVLink instead. What the design does
about it: the wire is written once, by the encode, into the peer's
receive row (no send staging), and read once, by the decode, eight
values a thread; a spin wait must never wait on a block that is not
resident, so the grids are launched cooperatively, and each is sized by
the call's work (:meth:`PeerWorld.a2a_blocks`,
:meth:`PeerWorld.ar_blocks`), at most the cap of the kernel's
instantiation (``PeerWorld.caps``). The world keeps each pad's running
target (:meth:`PeerWorld.pad_targets`), since the waits count peer
blocks.

A :class:`PeerWorld` holds the ranks' receive buffers and signal pads,
one buffer and one pad a rank for each protocol it serves (its
``collective_id``: the AllReduce's two phases and the All2All never
alias), sized from :mod:`repro_torch.kernels.protocol`, and the peer
table the kernels push through. Two kinds:

* :meth:`PeerWorld.loopback` puts ``tp`` ranks on one card: their
  buffers are slices of one allocation, and one cooperative launch runs
  every rank's copy of a kernel;
* :meth:`PeerWorld.from_group` is one rank of a world of processes (one
  rank a process, on a card of its own or sharing one): each rank
  allocates its buffers with ``cudaMalloc``, exchanges CUDA IPC handles
  over the process group and opens its peers'; each process launches its
  own rank.

The device code is the same in both. The wrappers take CUDA tensors only
and raise for anything else; :mod:`repro_torch.kernels.ops` decides which
path a call takes. ``*_plain`` are the plain PyTorch versions.
``LAUNCHES`` counts the kernels' launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import wire
from repro_torch.kernels.protocol import (A2A_COLLECTIVE_ID,
                                          ALLREDUCE_GATHER_COLLECTIVE_ID,
                                          ALLREDUCE_SCATTER_COLLECTIVE_ID,
                                          KernelProtocol,
                                          allreduce_gather_protocol,
                                          allreduce_scatter_protocol,
                                          live_protocols)

SOURCE = "rdma.cu"
AR_SOURCE = "allreduce.cu"
MAX_PEERS = 16                    # csrc/peer.cuh kMaxPeers
PEER_HEAD = 15                    # csrc/peer.cuh kPeerHead
AR_TILE = 2048                    # csrc/allreduce.cu kTile: values a tile
A2A_THREADS = 256                 # csrc/rdma.cu kThreads: threads a block
A2A_PER = 8                       # csrc/codec.cuh kPer: values a thread
#: csrc/allreduce.cu kStamps: fc_ar's step boundaries, as block 0 of a
#: rank sees them on the card's clock (:func:`fused_all_reduce_rdma`)
AR_STAMPS = ("start", "barrier", "encode", "scatter wait", "reduce",
             "gather wait", "decode")
#: fc_ar's instantiations: (group, spike, rotation)
AR_MODES = tuple((g, s, r) for g in (32, 64, 128)
                 for s, r in ((False, False), (True, False), (False, True)))
_IN_KINDS = {torch.float32: 0, torch.bfloat16: 1}      # the model dtypes
#: fc_a2a's instantiations: ("a2a", group, spike, rotation, payload kind
#: of _IN_KINDS)
A2A_MODES = tuple(("a2a", *m, k) for m in AR_MODES for k in (0, 1))
FLAG_ONE_CARD = 1                 # csrc/peer.cuh kFlagOneCard
_ALIGN = 256
_HANDLE_BYTES = 64                # cudaIpcMemHandle_t

#: launches of each kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"a2a": 0, "ar": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load(SOURCE)
    lib.fc_a2a.argtypes = [ctypes.c_void_p] * 8
    lib.fc_a2a.restype = ctypes.c_int
    lib.fc_a2a_blocks_per_rank.argtypes = [ctypes.c_int] * 6
    lib.fc_a2a_blocks_per_rank.restype = ctypes.c_int
    for name, args in (
            ("fc_peer_alloc", [ctypes.c_int, ctypes.c_longlong,
                               ctypes.POINTER(ctypes.c_void_p)]),
            ("fc_peer_export", [ctypes.c_void_p, ctypes.c_char_p]),
            ("fc_peer_enable", [ctypes.c_int, ctypes.c_int]),
            ("fc_peer_open", [ctypes.c_int, ctypes.c_char_p,
                              ctypes.POINTER(ctypes.c_void_p)]),
            ("fc_peer_close", [ctypes.c_void_p]),
            ("fc_peer_free", [ctypes.c_void_p])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _ar_lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load(AR_SOURCE)
    lib.fc_ar.argtypes = [ctypes.c_void_p] * 10
    lib.fc_ar.restype = ctypes.c_int
    lib.fc_ar_blocks_per_rank.argtypes = [ctypes.c_int] * 5
    lib.fc_ar_blocks_per_rank.restype = ctypes.c_int
    return lib


def _blocks_per_rank(key, dev: int, local_ranks: int) -> int:
    """The most blocks a rank of a kernel can run, every block of
    ``local_ranks`` ranks resident on card ``dev`` at once: ``fc_a2a``'s
    instantiation for ``key`` an A2A_MODES entry, ``fc_ar``'s for an
    AR_MODES entry."""
    if key[0] == "a2a":
        _, group, spike, rot, kind = key
        bpr, name = (_lib().fc_a2a_blocks_per_rank(
            dev, local_ranks, group, int(spike), int(rot), kind),
            f"fc_a2a {key[1:]}")
    else:
        group, spike, rot = key
        bpr, name = (_ar_lib().fc_ar_blocks_per_rank(
            dev, local_ranks, group, int(spike), int(rot)), f"fc_ar {key}")
    if bpr < 1:
        raise RuntimeError(f"{name}: no resident grid for {local_ranks} "
                           f"ranks ({bpr})")
    return bpr


def cap_keys(protocols: Sequence[KernelProtocol]) -> List:
    """The grids a world serving ``protocols`` needs: one for each
    instantiation of fc_a2a and of fc_ar."""
    cids = {p.collective_id for p in protocols}
    keys = list(A2A_MODES) if A2A_COLLECTIVE_ID in cids else []
    if ALLREDUCE_SCATTER_COLLECTIVE_ID in cids:
        keys += list(AR_MODES)
    return keys


def ar_mode(cfg) -> Tuple[int, bool, bool]:
    """The AR_MODES entry of a config."""
    return cfg.group, bool(cfg.spike), bool(cfg.rotation)


def a2a_mode(cfg, dtype) -> Tuple:
    """The A2A_MODES entry of a config and payload dtype."""
    return ("a2a", *ar_mode(cfg), _IN_KINDS[dtype])


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


def signal_words(proto: KernelProtocol) -> int:
    """u32 counters of one rank's signal pad: the barrier, one for each
    receive slot, and the local slot (``csrc/peer.cuh``)."""
    return 1 + proto.sem_slots + 1


def _align(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def ar_protocols(tp: int) -> Tuple[KernelProtocol, KernelProtocol]:
    """The fused AllReduce's two phases."""
    return allreduce_scatter_protocol(tp), allreduce_gather_protocol(tp)


def rank_layout(protocols: Sequence[KernelProtocol], row_bytes: int
                ) -> Tuple[Dict[int, Tuple[int, int]], int]:
    """One rank's region: for each protocol in turn its receive rows, then
    its signal pad, each aligned -> ({collective_id: (receive offset, pad
    offset)}, bytes)."""
    offs, at = {}, 0
    for proto in protocols:
        recv = at
        at += _align(proto.buffer("recv").rows * row_bytes)
        offs[proto.collective_id] = (recv, at)
        at += _align(4 * signal_words(proto))
    return offs, at


class _DeviceBytes:
    """``nbytes`` of device memory at ``ptr``, for ``torch.as_tensor``."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 3}


class PeerWorld:
    """The receive buffers and signal pads of ``tp`` ranks, one of each a
    rank for every protocol served, and the peer tables the kernels push
    through.

    ``local_ranks`` of the ranks, from ``rank0`` on, run in each launch.
    ``recv[cid][r]`` is rank ``r``'s receive buffer of protocol ``cid``:
    the protocol's ``recv`` rows (one for each sender) of ``row_bytes``
    each; ``signal[cid][r]`` its pad of :func:`signal_words` counters,
    zero at the start and only ever added to. ``epochs[cid]`` counts the
    protocol's calls (on the host only). ``caps[key]`` is the most blocks
    a rank of a kernel's instantiation that are resident at once
    (:func:`cap_keys`), one count for every rank (a loopback world fills
    it at first use): the cap of a call's grid.
    ``targets[cid]`` holds the running sums that every rank's pad reaches
    after the calls so far (barrier, each receive slot, local slot;
    :meth:`pad_targets`). ``one_card`` (a loopback world) lets the
    kernels' fences stay at gpu scope.
    """

    def __init__(self, tp: int, local_ranks: int, rank0: int,
                 protocols: Sequence[KernelProtocol], bases: List[int],
                 row_bytes: int, device, storage: Optional[torch.Tensor] = None,
                 owned: Optional[int] = None, opened: Sequence[int] = ()):
        assert 1 <= tp <= MAX_PEERS, tp
        self.tp, self.local_ranks, self.rank0 = tp, local_ranks, rank0
        self.row_bytes = row_bytes
        self.device = torch.device(device)
        self.protocols = {p.collective_id: p for p in protocols}
        offs, self.rank_bytes = rank_layout(protocols, row_bytes)
        self.recv = {c: [b + o[0] for b in bases] for c, o in offs.items()}
        self.signal = {c: [b + o[1] for b in bases] for c, o in offs.items()}
        self.epochs: Dict[int, int] = dict.fromkeys(self.protocols, 0)
        self.caps: Dict = {}
        self.targets: Dict[int, List[int]] = {c: [0, 0, 0]
                                              for c in self.protocols}
        self.one_card = storage is not None
        self.storage = storage           # a loopback world's one allocation
        self._owned, self._opened = owned, list(opened)

    @classmethod
    def loopback(cls, tp: int, row_bytes: int, device="cuda",
                 protocols: Optional[Sequence[KernelProtocol]] = None
                 ) -> "PeerWorld":
        """``tp`` ranks on one device, in one zeroed allocation, rank after
        rank; every live protocol unless ``protocols`` is given."""
        protocols = protocols or live_protocols(tp)
        _, rank_bytes = rank_layout(protocols, row_bytes)
        storage = torch.zeros(tp * rank_bytes, dtype=torch.uint8,
                              device=device)
        base = storage.data_ptr()
        return cls(tp, tp, 0, protocols,
                   [base + r * rank_bytes for r in range(tp)], row_bytes,
                   storage.device, storage=storage)

    @classmethod
    def from_group(cls, group, rank: int, row_bytes: int,
                   device=None) -> "PeerWorld":
        """Rank ``rank`` of the world of the process group ``group``, on
        ``device`` (the current CUDA device by default), serving every
        live protocol (:func:`~repro_torch.kernels.protocol.
        live_protocols`: the AllReduce's two phases and the All2All).

        Builds the kernels first, so that no rank's first launch waits on
        a peer that is still compiling. Then allocates this rank's region
        (:func:`rank_layout`) with ``cudaMalloc``, zeroed, exchanges its
        CUDA IPC handle, card and grid over ``group``, enables peer access
        to peers on other cards and opens their handles. Every rank
        takes one cap for each kernel grid (:func:`cap_keys`): the least
        over the ranks. Call :meth:`close` on every rank, after a barrier,
        when done.
        """
        import torch.distributed as dist
        device = torch.device(device if device is not None else "cuda")
        if device.type != "cuda":
            raise ValueError(f"PeerWorld.from_group: expected a CUDA device, "
                             f"got {device}")
        tp = dist.get_world_size(group)
        protocols = live_protocols(tp)
        dev = device.index if device.index is not None else \
            torch.cuda.current_device()
        lib = _lib()
        _ar_lib()
        _, rank_bytes = rank_layout(protocols, row_bytes)
        ptr = ctypes.c_void_p()
        _check_rc(lib.fc_peer_alloc(dev, rank_bytes, ctypes.byref(ptr)),
                  "fc_peer_alloc")
        handle = ctypes.create_string_buffer(_HANDLE_BYTES)
        _check_rc(lib.fc_peer_export(ptr, handle), "fc_peer_export")
        caps = {k: _blocks_per_rank(k, dev, 1) for k in cap_keys(protocols)}
        info = {"rank": rank, "device": dev, "handle": handle.raw,
                "caps": caps}
        infos: List = [None] * tp
        dist.all_gather_object(infos, info, group=group)
        if [i["rank"] for i in infos] != list(range(tp)):
            raise RuntimeError(f"PeerWorld.from_group: ranks "
                               f"{[i['rank'] for i in infos]} are not the "
                               f"group's 0..{tp - 1}")
        bases, opened = [], []
        for r, peer in enumerate(infos):
            if r == rank:                    # a process cannot open its own
                bases.append(ptr.value)
                continue
            _check_rc(lib.fc_peer_enable(dev, peer["device"]),
                      f"peer access from card {dev} to {peer['device']}")
            p = ctypes.c_void_p()
            _check_rc(lib.fc_peer_open(dev, peer["handle"], ctypes.byref(p)),
                      f"opening rank {r}'s IPC handle")
            bases.append(p.value)
            opened.append(p.value)
        world = cls(tp, 1, rank, protocols, bases, row_bytes,
                    torch.device("cuda", dev), owned=ptr.value, opened=opened)
        world.caps = {k: min(i["caps"][k] for i in infos) for k in caps}
        return world

    def close(self) -> None:
        """Close the peers' handles and free this rank's region (a world
        of processes; a loopback world's storage is PyTorch's). No kernel
        of any rank may still run on the world."""
        if self._owned is None:
            return
        lib = _lib()
        for p in self._opened:
            _check_rc(lib.fc_peer_close(p), "fc_peer_close")
        _check_rc(lib.fc_peer_free(self._owned), "fc_peer_free")
        self._owned, self._opened = None, []

    def _bytes(self, ptr: int, nbytes: int) -> torch.Tensor:
        if self.storage is not None:
            off = ptr - self.storage.data_ptr()
            return self.storage[off:off + nbytes]
        if ptr < self._owned or ptr + nbytes > self._owned + self.rank_bytes:
            raise ValueError("a world of processes shows its own rank's "
                             "buffers only")
        return torch.as_tensor(_DeviceBytes(ptr, nbytes), device=self.device)

    def recv_rows(self, rank: int,
                  cid: int = A2A_COLLECTIVE_ID) -> torch.Tensor:
        """Rank ``rank``'s receive buffer of protocol ``cid``, (recv rows,
        row_bytes) uint8 (every rank's in a loopback world, the own rank's
        in a world of processes)."""
        rows = self.protocols[cid].buffer("recv").rows
        return self._bytes(self.recv[cid][rank],
                           rows * self.row_bytes).view(rows, self.row_bytes)

    def signal_pad(self, rank: int, cid: int = A2A_COLLECTIVE_ID
                   ) -> torch.Tensor:
        """Rank ``rank``'s signal pad of protocol ``cid``,
        (signal_words,) int32 view."""
        n = signal_words(self.protocols[cid])
        return self._bytes(self.signal[cid][rank], 4 * n).view(torch.int32)

    def _protocol(self, cid: int, what: str) -> KernelProtocol:
        if cid not in self.protocols:
            raise ValueError(f"{what}: the world does not serve collective "
                             f"id {cid} (it serves "
                             f"{sorted(self.protocols)})")
        return self.protocols[cid]

    def table(self, cid: int, m: int = 0, in_kind: int = 0,
              blocks: int = 0, flags: int = 0) -> np.ndarray:
        """The kernels' int64 peer argument for protocol ``cid``
        (``csrc/peer.cuh`` read_peer): a launch of ``blocks`` blocks a
        rank, the pad targets as they stand."""
        proto = self.protocols[cid]
        cols = np.zeros((5, MAX_PEERS), np.int64)
        cols[0, :self.tp] = self.recv[cid]
        cols[1, :self.tp] = self.signal[cid]
        offs = proto.barrier.signal_offsets
        cols[2, :len(offs)] = offs
        cols[3, :len(proto.pushes)] = [s.dst_off for s in proto.pushes]
        cols[4, :len(proto.pushes)] = [s.recv_slot for s in proto.pushes]
        head = [self.tp, self.local_ranks, self.rank0, m, self.row_bytes,
                blocks, in_kind, proto.sem_slots,
                len(offs), proto.barrier.wait_count, len(proto.pushes),
                *(v % 2 ** 32 for v in self.targets[cid]), flags]
        assert len(head) == PEER_HEAD
        return np.concatenate([np.array(head, np.int64), cols.reshape(-1)])

    def _cap(self, key) -> int:
        if key not in self.caps:
            self.caps[key] = _blocks_per_rank(key, self.device.index or 0,
                                              self.local_ranks)
        return self.caps[key]

    def _advance(self, cid: int, blocks: int, barrier: bool) -> None:
        """Count one call of protocol ``cid`` of ``blocks`` blocks a rank
        into its pad targets: the ring barrier (if it runs) adds each
        peer block's signal to a rank's barrier, and every block adds one
        to each receive slot (its push step's) and one to the local
        slot."""
        t = self.targets[cid]
        if barrier:
            t[0] += self.protocols[cid].barrier.wait_count * blocks
        t[1] += blocks
        t[2] += blocks
        self.epochs[cid] += 1

    def pad_targets(self, cid: int) -> List[int]:
        """What every rank's pad of protocol ``cid`` holds once the calls
        so far have ended: barrier, each receive slot, local slot."""
        bar, slot, local = self.targets[cid]
        return [bar] + [slot] * self.protocols[cid].sem_slots + [local]

    def a2a_blocks(self, m: int, d: int, cfg, dtype) -> int:
        """``fc_a2a``'s blocks a rank for a call of ``m`` rows of ``d``
        values a peer, payload ``dtype``, in config ``cfg``: one for each
        A2A_THREADS items of A2A_PER values of the rank's tp * m rows, at
        most the cap of the instantiation. The same on every rank for a
        given (tp, m, d, cfg, dtype) and caps."""
        items = self.tp * m * (d // A2A_PER)
        return max(1, min(self._cap(a2a_mode(cfg, dtype)),
                          -(-items // A2A_THREADS)))

    def a2a_call(self, m: int, d: int, cfg, dtype
                 ) -> Tuple[int, np.ndarray]:
        """Count one ``fc_a2a`` call of ``m`` rows of ``d`` values a peer
        -> (blocks a rank, its peer table)."""
        blocks = self.a2a_blocks(m, d, cfg, dtype)
        self._advance(A2A_COLLECTIVE_ID, blocks, barrier=True)
        flags = FLAG_ONE_CARD if self.one_card else 0
        return blocks, self.table(A2A_COLLECTIVE_ID, m, _IN_KINDS[dtype],
                                  blocks, flags)

    def ar_blocks(self, n: int, cfg) -> int:
        """``fc_ar``'s blocks a rank for a call of ``n`` values a rank in
        config ``cfg``: one for each tile of AR_TILE values of the tp
        chunk rows, at most the cap of the config's instantiation. The
        same on every rank for a given (n, tp, cfg) and caps."""
        tiles = -(-(n // self.tp) // AR_TILE)
        return max(1, min(self._cap(ar_mode(cfg)), self.tp * tiles))

    def ar_call(self, n: int, cfg) -> Tuple[int, np.ndarray, np.ndarray]:
        """Count one ``fc_ar`` call of ``n`` values a rank -> (blocks a
        rank, scatter table, gather table). One grid for both protocols;
        the gather protocol runs no ring barrier (``csrc/allreduce.cu``
        says why)."""
        blocks = self.ar_blocks(n, cfg)
        flags = FLAG_ONE_CARD if self.one_card else 0
        tabs = []
        for cid, barrier in ((ALLREDUCE_SCATTER_COLLECTIVE_ID, True),
                             (ALLREDUCE_GATHER_COLLECTIVE_ID, False)):
            self._advance(cid, blocks, barrier)
            tabs.append(self.table(cid, 0, 0, blocks, flags))
        return blocks, tabs[0], tabs[1]


def fused_all_to_all_rdma(x: torch.Tensor, cfg,
                          world: PeerWorld) -> torch.Tensor:
    """(local_ranks, tp, m, d) payload on the card -> the same shape and
    dtype: ``out[r][j]`` is what rank ``j`` sent rank ``r``, through the
    wire codec of ``cfg`` (``d`` a group multiple). One launch of
    ``fc_a2a`` of :meth:`PeerWorld.a2a_blocks` blocks a rank."""
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
    if x.device != world.device:
        raise ValueError("fused_all_to_all_rdma: the payload and the world "
                         "are on different devices")
    if m * cfg.wire_bytes(d) > world.row_bytes:
        raise ValueError(f"fused_all_to_all_rdma: {m} rows of "
                         f"{cfg.wire_bytes(d)} wire bytes exceed the "
                         f"world's {world.row_bytes}-byte receive rows")
    world._protocol(A2A_COLLECTIVE_ID, "fused_all_to_all_rdma")
    out = torch.empty_like(x)
    if m * d == 0:
        return out
    a, thr, frac, f = wire._params(cfg, tp * m, d, wire._OUT_KINDS[x.dtype])
    with torch.cuda.device(x.device):
        _, peer = world.a2a_call(m, d, cfg, x.dtype)
        rc = _lib().fc_a2a(x.data_ptr(), out.data_ptr(), a.ctypes.data,
                           thr.ctypes.data, frac.ctypes.data, f.ctypes.data,
                           peer.ctypes.data,
                           torch.cuda.current_stream(x.device).cuda_stream)
    _check_rc(rc, "fc_a2a launch")
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


# ---------------------------------------------------------------------------
# the fused two-step AllReduce
# ---------------------------------------------------------------------------

def fused_all_reduce_rdma(x: torch.Tensor, cfg, world: PeerWorld,
                          stamps: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The fused two-step AllReduce of f32 vectors of ``n`` values,
    ``n / tp`` a group multiple: ``(local_ranks, n)`` (a loopback world:
    every local rank's vector) or ``(n,)`` (a world of processes: this
    rank's) on the card -> the same shape, each rank's row the quantized
    sum over the ranks. One launch of ``fc_ar`` (encode and push, decode
    and sum the rank's chunk, quantize the sum and push it to every peer,
    decode all chunks) of :meth:`PeerWorld.ar_blocks` blocks a rank.

    ``stamps`` is a measurement hook, left None on the serve paths: a
    ``(local_ranks, len(AR_STAMPS))`` int64 tensor on the card that
    receives the card's clock (ns) at each of ``AR_STAMPS`` as block 0 of
    each rank passes it, where a call's time goes (``chip_smoke.py``
    phase ar)."""
    wire._check_cfg(cfg)
    if x.dtype != torch.float32:
        raise TypeError(f"fused_all_reduce_rdma: expected float32, got "
                        f"{x.dtype}")
    xs = x[None] if x.dim() == 1 and world.local_ranks == 1 else x
    if (xs.dim() != 2 or xs.shape[0] != world.local_ranks
            or not xs.is_contiguous()):
        raise ValueError(f"fused_all_reduce_rdma: expected a contiguous "
                         f"({world.local_ranks}, n) tensor"
                         f"{' or (n,)' if world.local_ranks == 1 else ''}, "
                         f"got {tuple(x.shape)}")
    tp, n = world.tp, xs.shape[1]
    if n % tp or (n // tp) % cfg.group:
        raise ValueError(f"fused_all_reduce_rdma: chunk n / tp = {n} / {tp} "
                         f"is not a multiple of the group {cfg.group}")
    chunk = n // tp
    if cfg.wire_bytes(chunk) > world.row_bytes:
        raise ValueError(f"fused_all_reduce_rdma: a wire row of "
                         f"{cfg.wire_bytes(chunk)} bytes exceeds the "
                         f"world's {world.row_bytes}-byte receive rows")
    if x.device.type != "cuda":
        raise ValueError(f"fused_all_reduce_rdma: expected a CUDA tensor, "
                         f"got {x.device}")
    if x.device != world.device:
        raise ValueError("fused_all_reduce_rdma: the vector and the world "
                         "are on different devices")
    for cid in (ALLREDUCE_SCATTER_COLLECTIVE_ID,
                ALLREDUCE_GATHER_COLLECTIVE_ID):
        world._protocol(cid, "fused_all_reduce_rdma")
    if stamps is not None and (
            stamps.shape != (world.local_ranks, len(AR_STAMPS))
            or stamps.dtype != torch.int64 or stamps.device != x.device
            or not stamps.is_contiguous()):
        raise ValueError(f"fused_all_reduce_rdma: stamps must be a "
                         f"contiguous ({world.local_ranks}, "
                         f"{len(AR_STAMPS)}) int64 tensor on {x.device}")
    out = torch.empty_like(xs)
    if n == 0:
        return out.reshape(x.shape)
    a, thr, frac, f = wire._params(cfg, tp, chunk)
    with torch.cuda.device(x.device):
        _, scatter, gather = world.ar_call(n, cfg)
        rc = _ar_lib().fc_ar(
            xs.data_ptr(), out.data_ptr(), a.ctypes.data, thr.ctypes.data,
            frac.ctypes.data, f.ctypes.data, scatter.ctypes.data,
            gather.ctypes.data, 0 if stamps is None else stamps.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _check_rc(rc, "fc_ar launch")
    LAUNCHES["ar"] += 1
    return out.reshape(x.shape)


def fused_all_reduce_rdma_plain(x: torch.Tensor, cfg):
    """The plain version: (tp, n) f32, every rank's vector -> (out,
    scatter_recv, gather_recv): ``out`` (tp, n) as the kernels' (every row
    the same), ``scatter_recv[r]`` / ``gather_recv[r]`` rank ``r``'s
    receive rows of each phase, (tp, tp, wire_bytes(n / tp)) uint8 (row
    ``j`` from rank ``j``). Phase 1 sums the decoded rows in row order
    from +0.0, as ``fc_decode_reduce`` and ``sum_rows`` do."""
    tp, n = x.shape
    chunk = n // tp
    sent = wire.encode_plain(x.reshape(tp * tp, chunk).to(torch.float32),
                             cfg)
    wb = sent.shape[1]
    scatter = sent.reshape(tp, tp, wb).transpose(0, 1).contiguous()
    parts = wire.decode_plain(scatter.reshape(-1, wb), cfg, chunk
                              ).reshape(tp, tp, chunk)
    partial = torch.zeros((tp, chunk), dtype=torch.float32, device=x.device)
    for j in range(tp):
        partial = partial + parts[:, j]
    sent2 = wire.encode_plain(partial, cfg)                  # (tp, wb)
    gather = sent2[None].expand(tp, tp, wb).contiguous()
    out = wire.decode_plain(sent2, cfg, chunk).reshape(1, n)
    return out.expand(tp, n).contiguous(), scatter, gather


def bound_bytes_ar(cfg, tp: int, n: int) -> int:
    """Bytes one rank of the AllReduce must move: x read once (4n), tp
    wire rows of ``wire_bytes(n / tp)`` written and read once in each
    phase, the output written once (4n). The partial sum stays in
    registers."""
    return 8 * n + 4 * tp * cfg.wire_bytes(n // tp)
