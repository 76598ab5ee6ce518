"""Peer-push choreography declared as data (the port's copy).

Every peer-push kernel declares its per-rank protocol -- barrier
signalling, per-peer signal slots, buffer roles, the collective id -- as
a :class:`KernelProtocol` value, field for field the JAX package's
declarations (``tests/test_torch_rdma.py`` holds them equal), so one
choreography is checked by the JAX package's analyzer and executed here:

* :mod:`repro_torch.kernels.rdma` sizes the receive rows and the signal
  pads of a :class:`~repro_torch.kernels.rdma.PeerWorld` from
  :func:`all2all_protocol`, and hands the barrier's ``signal_offsets``
  and ``wait_count`` to the kernel;
* ``csrc/peer.cuh`` executes them: the ring barrier signals each peer at
  ``(my + off) % tp`` and waits for ``wait_count`` signals, and push step
  ``i`` writes into peer ``my + i``'s receive row ``my`` and signals the
  peer's slot ``recv_slot`` (``i - 1``).

Row symbols: a ``PushStep`` row is either a concrete int or one of the
symbols ``"my"`` (this rank's index along the communicated axis) /
``"dst"`` (the destination peer's index), resolved by
:func:`resolve_row`.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple, Union

RowSym = Union[int, str]          # int | "my" | "dst"

#: Program opcodes (see :class:`KernelProtocol.program`).
WRITE = "write"      # local write into a staging buffer
BARRIER = "barrier"  # ring barrier: signal all peers, wait for them
PUSH = "push"        # start every PushStep's make_async_remote_copy
WAIT = "wait"        # wait on every started descriptor (send + recv)
READ = "read"        # local read of a buffer (decode / splice)


class PushStep(NamedTuple):
    """One push issued by every rank (SPMD).

    The destination peer is ``(my + dst_off) % tp`` along the
    communicated axis; the push moves ``src_buf[src_row]`` into the
    peer's ``dst_buf[dst_row]``, and the peer's ``recv_slot`` signal
    counts it when the bytes have landed (``send_slot`` is the sender's
    completion slot of the JAX kernels' DMA semaphores). By SPMD
    symmetry the local wait at slot ``recv_slot`` pairs with the incoming
    push from peer ``(my - dst_off) % tp``.
    """
    dst_off: int
    src_row: RowSym
    dst_row: RowSym
    send_slot: int
    recv_slot: int


class RingBarrier(NamedTuple):
    """Barrier plan: signal the global barrier semaphore of each peer at
    ``(my + off) % tp`` (``inc=1`` per offset), then wait until the own
    barrier count reaches ``wait_count``."""
    signal_offsets: Tuple[int, ...]
    wait_count: int


class BufferSpec(NamedTuple):
    """Lifetime role of one communication buffer.

    ``remote_writable`` buffers are landing zones: peers write into
    them, so they must be live (post-barrier) before any push starts and
    must not be read before the matching waits complete.
    """
    name: str
    rows: int
    remote_writable: bool


class KernelProtocol(NamedTuple):
    """The full per-rank choreography of one peer-push kernel.

    ``program`` is the rank-local op order -- tuples of
    ``(WRITE, buf) | (BARRIER,) | (PUSH,) | (WAIT,) | (READ, buf)`` --
    the happens-before skeleton. ``sem_slots`` is the number of receive
    signal slots, and ``collective_id`` the barrier identity that must be
    unique among kernels live in one program.
    """
    name: str
    collective_id: int
    sem_slots: int
    buffers: Tuple[BufferSpec, ...]
    barrier: RingBarrier
    pushes: Tuple[PushStep, ...]
    push_src: str
    push_dst: str
    program: Tuple[Tuple[str, ...], ...]

    def buffer(self, name: str) -> BufferSpec:
        for b in self.buffers:
            if b.name == name:
                return b
        raise KeyError(name)


def resolve_row(sym: RowSym, my, dst):
    """Resolve a row symbol against (my, dst)."""
    if sym == "my":
        return my
    if sym == "dst":
        return dst
    return sym


def ring_barrier(tp: int) -> RingBarrier:
    """The standard all-peers ring barrier: signal every other rank on
    the axis once, wait for the tp-1 symmetric signals."""
    return RingBarrier(signal_offsets=tuple(range(1, tp)),
                       wait_count=tp - 1)


def ring_pushes(tp: int, src_row: RowSym, dst_row: RowSym
                ) -> Tuple[PushStep, ...]:
    """The shared per-peer push plan: iteration ``i`` sends to peer
    ``my + i`` using semaphore slot ``i - 1`` in both directions (the
    matching receive at slot ``i - 1`` comes from peer ``my - i``)."""
    return tuple(PushStep(dst_off=i, src_row=src_row, dst_row=dst_row,
                          send_slot=i - 1, recv_slot=i - 1)
                 for i in range(1, tp))


def _standard_program(src: str, dst: str) -> Tuple[Tuple[str, ...], ...]:
    """write staging -> barrier -> push -> wait -> read (decode)."""
    return ((WRITE, src), (BARRIER,), (PUSH,), (WAIT,),
            (READ, dst), (READ, src))


# ---------------------------------------------------------------------------
# the shipped protocols
# ---------------------------------------------------------------------------

# Barrier identities. The AllReduce claims 0 (scatter-reduce) and 1
# (gather); the A2A kernel must not alias either since all three can be
# live in one train step.
ALLREDUCE_SCATTER_COLLECTIVE_ID = 0
ALLREDUCE_GATHER_COLLECTIVE_ID = 1
A2A_COLLECTIVE_ID = 2


def allreduce_scatter_protocol(tp: int) -> KernelProtocol:
    """Phase 1 of the fused AR: encode tp chunk rows, push row ``dst``
    of the send staging to peer ``dst``'s receive row ``my``, decode +
    reduce the received rows (own row spliced locally)."""
    return KernelProtocol(
        name="allreduce_scatter_reduce",
        collective_id=ALLREDUCE_SCATTER_COLLECTIVE_ID,
        sem_slots=tp - 1,
        buffers=(BufferSpec("send", tp, False),
                 BufferSpec("recv", tp, True)),
        barrier=ring_barrier(tp),
        pushes=ring_pushes(tp, src_row="dst", dst_row="my"),
        push_src="send", push_dst="recv",
        program=_standard_program("send", "recv"))


def allreduce_gather_protocol(tp: int) -> KernelProtocol:
    """Phase 2 of the fused AR: encode the single partial-sum row, push
    it into every peer's gather row ``my``, decode all tp rows."""
    return KernelProtocol(
        name="allreduce_gather",
        collective_id=ALLREDUCE_GATHER_COLLECTIVE_ID,
        sem_slots=tp - 1,
        buffers=(BufferSpec("send", 1, False),
                 BufferSpec("recv", tp, True)),
        barrier=ring_barrier(tp),
        pushes=ring_pushes(tp, src_row=0, dst_row="my"),
        push_src="send", push_dst="recv",
        program=_standard_program("send", "recv"))


def all2all_protocol(tp: int) -> KernelProtocol:
    """The fused A2A: encode tp per-peer blocks, push block ``dst`` to
    peer ``dst``'s receive row ``my`` (all-to-all order), decode."""
    return KernelProtocol(
        name="all2all",
        collective_id=A2A_COLLECTIVE_ID,
        sem_slots=tp - 1,
        buffers=(BufferSpec("send", tp, False),
                 BufferSpec("recv", tp, True)),
        barrier=ring_barrier(tp),
        pushes=ring_pushes(tp, src_row="dst", dst_row="my"),
        push_src="send", push_dst="recv",
        program=_standard_program("send", "recv"))


def live_protocols(tp: int) -> Tuple[KernelProtocol, ...]:
    """Every peer-push protocol that can be live in one program (a train
    step runs the AR phases and the MoE A2A together): the set whose
    collective ids must not collide."""
    return (allreduce_scatter_protocol(tp),
            allreduce_gather_protocol(tp),
            all2all_protocol(tp))
