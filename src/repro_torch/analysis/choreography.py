"""Choreography checker: the N-rank happens-before analysis.

The port's copy of the JAX package's ``analysis/choreography.py``.
Consumes the :class:`repro_torch.kernels.protocol.KernelProtocol`
declarations the peer-push kernels execute (``csrc/peer.cuh``),
instantiates them for every rank along the communicated axis, and
proves:

* **slot matching** (CHOREO-SLOT): every DMA descriptor owns a unique
  send and a unique receive semaphore slot, and each rank's slot ``k``
  receives exactly one incoming push — so a ``wait()`` certifies *its
  own* transfer, not a different peer's;
* **signal/wait accounting** (CHOREO-SEM): each rank receives exactly
  ``wait_count`` barrier signals (an undershoot stalls, an overshoot
  leaves residue that poisons the next kernel sharing the barrier);
* **buffer-lifetime races** (CHOREO-RACE): pushes happen only after the
  liveness barrier, landing buffers are only read after their waits,
  staging is written before it is pushed;
* **bounds** (CHOREO-BOUNDS): every resolved push row and semaphore
  slot stays inside the declared shapes;
* **deadlock freedom** (CHOREO-DEADLOCK): a round-based simulation of
  all ranks with counting semaphores; DMA completion is modelled as
  eager (remote writes land without receiver action once buffers are
  live — the liveness itself is the separate RACE rule), which is sound
  for deadlock detection: anything stuck under eager completion is
  stuck under every slower schedule;
* **collective_id collisions** (CHOREO-ID): kernels that can be live in
  one compiled program must not share a barrier semaphore identity.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from repro_torch.analysis.report import Diagnostic, err
from repro_torch.kernels.protocol import (BARRIER, PUSH, READ, WAIT, WRITE,
                                    KernelProtocol, resolve_row)

# simulation cap: each rank executes at most this many op attempts; the
# real programs are a handful of ops, so hitting the cap means livelock
_MAX_ROUNDS = 10_000


def _subject(proto: KernelProtocol, tp: int) -> str:
    return f"{proto.name} tp={tp}"


# ---------------------------------------------------------------------------
# static structure checks
# ---------------------------------------------------------------------------

def _check_slots(proto: KernelProtocol, tp: int) -> List[Diagnostic]:
    out = []
    sub = _subject(proto, tp)
    sends = [s.send_slot for s in proto.pushes]
    recvs = [s.recv_slot for s in proto.pushes]
    if len(set(sends)) != len(sends):
        out.append(err("CHOREO-SLOT",
                       f"send slots {sends} are shared between "
                       f"descriptors", sub))
    if len(set(recvs)) != len(recvs):
        out.append(err("CHOREO-SLOT",
                       f"recv slots {recvs} are shared between "
                       f"descriptors — a wait on a shared slot can "
                       f"certify another peer's transfer", sub))
    # SPMD: incoming pushes to rank r at slot k = #steps with
    # recv_slot == k (one per distinct sender offset); each local wait
    # consumes one, so per-slot incoming must be exactly 1
    incoming: Dict[int, int] = {}
    for s in proto.pushes:
        incoming[s.recv_slot] = incoming.get(s.recv_slot, 0) + 1
    for slot, cnt in incoming.items():
        if cnt != 1:
            out.append(err("CHOREO-SLOT",
                           f"recv slot {slot} receives {cnt} incoming "
                           f"pushes per rank (want exactly 1)", sub))
    return out


def _check_bounds(proto: KernelProtocol, tp: int) -> List[Diagnostic]:
    out = []
    sub = _subject(proto, tp)
    src = proto.buffer(proto.push_src)
    dst = proto.buffer(proto.push_dst)
    for s in proto.pushes:
        if not (0 <= s.send_slot < proto.sem_slots
                and 0 <= s.recv_slot < proto.sem_slots):
            out.append(err("CHOREO-BOUNDS",
                           f"step dst_off={s.dst_off} uses semaphore "
                           f"slots ({s.send_slot}, {s.recv_slot}) "
                           f"outside [0, {proto.sem_slots})", sub))
        for my in range(tp):
            d = (my + s.dst_off) % tp
            sr = resolve_row(s.src_row, my, d)
            dr = resolve_row(s.dst_row, my, d)
            if not 0 <= sr < src.rows:
                out.append(err("CHOREO-BOUNDS",
                               f"rank {my} step dst_off={s.dst_off}: "
                               f"src row {sr} outside "
                               f"{src.name}[0, {src.rows})", sub))
                break
            if not 0 <= dr < dst.rows:
                out.append(err("CHOREO-BOUNDS",
                               f"rank {my} step dst_off={s.dst_off}: "
                               f"dst row {dr} outside "
                               f"{dst.name}[0, {dst.rows})", sub))
                break
    return out


def _check_barrier(proto: KernelProtocol, tp: int) -> List[Diagnostic]:
    out = []
    sub = _subject(proto, tp)
    offs = proto.barrier.signal_offsets
    if any(o % tp == 0 for o in offs):
        out.append(err("CHOREO-SEM",
                       f"barrier signals itself (offset 0 mod tp in "
                       f"{offs})", sub))
    if len(set(o % tp for o in offs)) != len(offs):
        out.append(err("CHOREO-SEM",
                       f"duplicate barrier signal offsets {offs}", sub))
    # SPMD symmetry: every rank receives exactly len(offs) signals
    received = len(offs)
    if received != proto.barrier.wait_count:
        effect = ("stall" if received < proto.barrier.wait_count
                  else "stale residue for the next collective")
        out.append(err("CHOREO-SEM",
                       f"each rank receives {received} barrier signals "
                       f"but waits for {proto.barrier.wait_count} "
                       f"({effect})", sub))
    return out


def _check_program_order(proto: KernelProtocol,
                         tp: int) -> List[Diagnostic]:
    out = []
    sub = _subject(proto, tp)
    prog = proto.program
    ops = [op[0] for op in prog]
    if not proto.buffer(proto.push_dst).remote_writable:
        out.append(err("CHOREO-RACE",
                       f"push destination {proto.push_dst!r} is not "
                       f"declared remote-writable", sub))
    if PUSH in ops:
        push_i = ops.index(PUSH)
        if BARRIER not in ops[:push_i]:
            out.append(err("CHOREO-RACE",
                           "push starts before the liveness barrier — "
                           "a fast rank's RDMA can land in a peer's "
                           "buffer before that peer allocated it", sub))
        writes = [i for i, op in enumerate(prog)
                  if op[0] == WRITE and op[1] == proto.push_src]
        if not writes or min(writes) > push_i:
            out.append(err("CHOREO-RACE",
                           f"staging buffer {proto.push_src!r} is "
                           f"pushed before it is written", sub))
        if WAIT not in ops[push_i:]:
            out.append(err("CHOREO-RACE",
                           "pushes are never waited on before the "
                           "kernel returns", sub))
    wait_i = ops.index(WAIT) if WAIT in ops else len(ops)
    for i, op in enumerate(prog):
        if op[0] == READ and op[1] == proto.push_dst and i < wait_i:
            out.append(err("CHOREO-RACE",
                           f"landing buffer {proto.push_dst!r} is read "
                           f"at program step {i} before the DMA waits",
                           sub))
    return out


# ---------------------------------------------------------------------------
# N-rank simulation with counting semaphores
# ---------------------------------------------------------------------------

class _Rank:
    """One simulated rank: a program counter plus counting semaphores."""

    def __init__(self, rank: int, tp: int, proto: KernelProtocol):
        self.rank = rank
        self.tp = tp
        self.proto = proto
        self.pc = 0                    # index into proto.program
        self.sub = 0                   # sub-step inside PUSH/WAIT/BARRIER
        self.barrier_sem = 0
        self.barrier_signalled = False
        self.send_sem = [0] * max(proto.sem_slots, 1)
        self.recv_sem = [0] * max(proto.sem_slots, 1)
        self.blocked_on = ""

    @property
    def done(self) -> bool:
        return self.pc >= len(self.proto.program)

    def step(self, ranks: Sequence["_Rank"]) -> bool:
        """Try to make progress; True if any state advanced."""
        if self.done:
            return False
        op = self.proto.program[self.pc]
        kind = op[0]
        if kind in (WRITE, READ):
            self.pc += 1
            return True
        if kind == BARRIER:
            plan = self.proto.barrier
            if not self.barrier_signalled:
                for off in plan.signal_offsets:
                    ranks[(self.rank + off) % self.tp].barrier_sem += 1
                self.barrier_signalled = True
                return True
            if self.barrier_sem >= plan.wait_count:
                self.barrier_sem -= plan.wait_count
                self.pc += 1
                return True
            self.blocked_on = (f"barrier wait "
                               f"({self.barrier_sem}/{plan.wait_count})")
            return False
        if kind == PUSH:
            # eager DMA completion: the copy lands immediately —
            # increment the local send slot and the peer's recv slot
            steps = self.proto.pushes
            if self.sub < len(steps):
                s = steps[self.sub]
                dst = (self.rank + s.dst_off) % self.tp
                if 0 <= s.send_slot < len(self.send_sem):
                    self.send_sem[s.send_slot] += 1
                if 0 <= s.recv_slot < len(ranks[dst].recv_sem):
                    ranks[dst].recv_sem[s.recv_slot] += 1
                self.sub += 1
                return True
            self.pc += 1
            self.sub = 0
            return True
        if kind == WAIT:
            steps = self.proto.pushes
            while self.sub < len(steps):
                s = steps[self.sub]
                ok_send = (0 <= s.send_slot < len(self.send_sem)
                           and self.send_sem[s.send_slot] >= 1)
                ok_recv = (0 <= s.recv_slot < len(self.recv_sem)
                           and self.recv_sem[s.recv_slot] >= 1)
                if not (ok_send and ok_recv):
                    def cnt(sems, slot):
                        return (sems[slot]
                                if 0 <= slot < len(sems) else "oob")
                    self.blocked_on = (
                        f"DMA wait on descriptor {self.sub} "
                        f"(send[{s.send_slot}]="
                        f"{cnt(self.send_sem, s.send_slot)}, "
                        f"recv[{s.recv_slot}]="
                        f"{cnt(self.recv_sem, s.recv_slot)})")
                    return False
                self.send_sem[s.send_slot] -= 1
                self.recv_sem[s.recv_slot] -= 1
                self.sub += 1
            self.pc += 1
            self.sub = 0
            return True
        raise ValueError(f"unknown program op {op!r}")


def simulate(proto: KernelProtocol, tp: int) -> List[Diagnostic]:
    """Round-based execution of all ``tp`` ranks; CHOREO-DEADLOCK when a
    full round makes no progress with unfinished ranks."""
    ranks = [_Rank(r, tp, proto) for r in range(tp)]
    for _ in range(_MAX_ROUNDS):
        progressed = False
        for r in ranks:
            while (not r.done) and r.step(ranks):
                progressed = True
        if all(r.done for r in ranks):
            return []
        if not progressed:
            stuck = [f"rank {r.rank} @ op {r.pc} "
                     f"({r.proto.program[r.pc][0]}): {r.blocked_on}"
                     for r in ranks if not r.done]
            return [err("CHOREO-DEADLOCK",
                        "no rank can make progress — "
                        + "; ".join(stuck[:4])
                        + ("; ..." if len(stuck) > 4 else ""),
                        _subject(proto, tp))]
    return [err("CHOREO-DEADLOCK",
                f"simulation did not terminate in {_MAX_ROUNDS} rounds "
                f"(livelock)", _subject(proto, tp))]


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def check_protocol(proto: KernelProtocol, tp: int) -> List[Diagnostic]:
    """All per-protocol checks for one axis size."""
    assert tp >= 2, "RDMA protocols need at least 2 ranks"
    out = []
    out += _check_slots(proto, tp)
    out += _check_bounds(proto, tp)
    out += _check_barrier(proto, tp)
    out += _check_program_order(proto, tp)
    out += simulate(proto, tp)
    return out


def check_collective_ids(protos: Sequence[KernelProtocol]
                         ) -> List[Diagnostic]:
    """Kernels live in one compiled program must not share a barrier
    collective_id (shared barriers would cross-signal)."""
    out = []
    seen: Dict[int, str] = {}
    for p in protos:
        if p.collective_id in seen:
            out.append(err("CHOREO-ID",
                           f"{p.name} reuses collective_id "
                           f"{p.collective_id} already claimed by "
                           f"{seen[p.collective_id]}",
                           f"{p.name}+{seen[p.collective_id]}"))
        else:
            seen[p.collective_id] = p.name
    return out


def check_choreography(tp_values: Sequence[int]
                       ) -> Tuple[List[Diagnostic], int]:
    """The shipped protocols across every axis size the launch meshes
    produce; returns (diags, subjects_checked)."""
    from repro_torch.kernels.protocol import live_protocols
    out: List[Diagnostic] = []
    checked = 0
    for tp in sorted(set(t for t in tp_values if t >= 2)):
        protos = live_protocols(tp)
        out += check_collective_ids(protos)
        for p in protos:
            out += check_protocol(p, tp)
            checked += 1
    return out, checked
