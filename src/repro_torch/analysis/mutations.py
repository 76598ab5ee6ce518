"""Mutation fixtures: deliberately broken inputs, one per rule.

The port's copy of the JAX package's ``analysis/mutations.py``: each of
its fixtures under the same name, the two VMEM fixtures replaced by
fixtures of the card's budget (:mod:`repro_torch.analysis.smem`), and a
fixture for each card rule.

A static analyzer that never fires is indistinguishable from one that
works — so every rule ships with a fixture that *must* trigger exactly
it. ``commcheck --selftest`` (and tests/test_torch_analysis.py) runs each
fixture and fails if its rule stays silent, proving the analyzer can
still catch the bug class it was built for.

Each fixture returns the diagnostics its broken input produces;
:func:`run_selftest` checks the expected rule is among them.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.analysis import choreography, frames, layout, sites, smem
from repro_torch.analysis.report import Diagnostic
from repro_torch.core.comm_config import CommConfig, Section, WireLayout
from repro_torch.kernels.protocol import (BARRIER, PUSH, READ, WAIT, WRITE,
                                    BufferSpec, RingBarrier,
                                    allreduce_scatter_protocol,
                                    ring_pushes)

_TP = 4


def _proto(**over):
    """The known-good scatter protocol with targeted field overrides."""
    return allreduce_scatter_protocol(_TP)._replace(**over)


# ---------------------------------------------------------------------------
# choreography mutants
# ---------------------------------------------------------------------------

def deadlock_wait_before_push() -> List[Diagnostic]:
    """WAIT ordered before PUSH: every rank blocks on a DMA that no one
    has started."""
    p = _proto(program=((WRITE, "send"), (BARRIER,), (WAIT,), (PUSH,),
                        (READ, "recv"), (READ, "send")))
    return choreography.check_protocol(p, _TP)


def deadlock_barrier_overwait() -> List[Diagnostic]:
    """Barrier waits for tp signals but only tp-1 arrive: permanent
    stall (fires CHOREO-SEM statically and CHOREO-DEADLOCK in the
    simulation)."""
    p = _proto(barrier=RingBarrier(tuple(range(1, _TP)), _TP))
    return choreography.check_protocol(p, _TP)


def slot_mismatch_shared_recv() -> List[Diagnostic]:
    """All descriptors share receive slot 0: a wait can certify another
    peer's transfer (counting semaphores still add up, so this is a
    *static* uniqueness rule, not a deadlock)."""
    pushes = tuple(s._replace(recv_slot=0)
                   for s in ring_pushes(_TP, "dst", "my"))
    p = _proto(pushes=pushes)
    return choreography.check_protocol(p, _TP)


def sem_self_signal() -> List[Diagnostic]:
    """Barrier offset 0 mod tp: a rank signals itself and nobody else
    completes its count."""
    p = _proto(barrier=RingBarrier((0,) + tuple(range(1, _TP - 1)),
                                   _TP - 1))
    return choreography.check_protocol(p, _TP)


def race_no_barrier() -> List[Diagnostic]:
    """Pushes start before the liveness barrier: a fast rank's RDMA can
    land in a peer's buffer before the peer allocated it."""
    p = _proto(program=((WRITE, "send"), (PUSH,), (BARRIER,), (WAIT,),
                        (READ, "recv"), (READ, "send")))
    return choreography.check_protocol(p, _TP)


def race_read_before_wait() -> List[Diagnostic]:
    """Landing buffer decoded before the DMA waits complete."""
    p = _proto(program=((WRITE, "send"), (BARRIER,), (PUSH,),
                        (READ, "recv"), (WAIT,), (READ, "send")))
    return choreography.check_protocol(p, _TP)


def bounds_bad_row() -> List[Diagnostic]:
    """A push addresses staging row tp (buffers have rows 0..tp-1)."""
    pushes = ring_pushes(_TP, "dst", "my")
    pushes = pushes[:-1] + (pushes[-1]._replace(src_row=_TP),)
    p = _proto(pushes=pushes)
    return choreography.check_protocol(p, _TP)


def bounds_bad_slot() -> List[Diagnostic]:
    """A descriptor uses semaphore slot sem_slots (one past the end)."""
    pushes = ring_pushes(_TP, "dst", "my")
    pushes = pushes[:-1] + (pushes[-1]._replace(send_slot=_TP - 1),)
    p = _proto(pushes=pushes)
    return choreography.check_protocol(p, _TP)


def id_collision() -> List[Diagnostic]:
    """Two kernels live in one program share a barrier collective_id."""
    a = allreduce_scatter_protocol(_TP)
    b = a._replace(name="other_kernel")
    return choreography.check_collective_ids([a, b])


def push_into_readonly() -> List[Diagnostic]:
    """Push destination not declared remote-writable."""
    p = _proto(buffers=(BufferSpec("send", _TP, False),
                        BufferSpec("recv", _TP, False)))
    return choreography.check_protocol(p, _TP)


# ---------------------------------------------------------------------------
# layout mutants (hand-built broken tables)
# ---------------------------------------------------------------------------

def _layout(planes, scale, zero, total, spike_vals=None, spike_idx=None):
    return WireLayout(n=128, planes=planes, scale=scale, zero=zero,
                      spike_vals=spike_vals, spike_idx=spike_idx,
                      total=total)


def layout_overlap() -> List[Diagnostic]:
    """Scale section starts inside the bit plane."""
    return layout.check_layout(
        _layout(planes=((8, Section(0, 128)),), scale=Section(120, 2),
                zero=Section(128, 2), total=130), "mutant")


def layout_gap() -> List[Diagnostic]:
    """Unaddressed bytes between plane and scale."""
    return layout.check_layout(
        _layout(planes=((8, Section(0, 128)),), scale=Section(136, 2),
                zero=Section(138, 2), total=140), "mutant")


def layout_bounds() -> List[Diagnostic]:
    """Zero section runs past the declared total."""
    return layout.check_layout(
        _layout(planes=((8, Section(0, 128)),), scale=Section(128, 2),
                zero=Section(130, 8), total=132), "mutant")


def layout_undercover() -> List[Diagnostic]:
    """Total larger than the byte span the sections cover."""
    return layout.check_layout(
        _layout(planes=((8, Section(0, 128)),), scale=Section(128, 2),
                zero=Section(130, 2), total=256), "mutant")


def spike_group_overflow() -> List[Diagnostic]:
    """group=512 under 1-byte (scale_int) spike indices: in-group
    indices silently wrap on the wire. ``CommConfig.__post_init__`` now
    refuses to construct this, so the raw-value checker is the fixture
    surface."""
    return layout.check_spike_capacity(512, True, "mutant")


# ---------------------------------------------------------------------------
# frame mutants (malformed framed buffers)
# ---------------------------------------------------------------------------

def _framed_wire():
    """One clean framed row + its config (mutation substrate)."""
    import torch
    from repro_torch.core import frame
    cc = CommConfig(bits=4, group=32, framed=True)
    x = np.random.RandomState(0).standard_normal((1, 64)).astype(
        np.float32)
    wire = frame.frame_encode(torch.from_numpy(x), cc)
    return np.asarray(wire).copy(), cc


def frame_bad_version() -> List[Diagnostic]:
    """Version byte from a future binary: must be version-rejected
    (before any checksum verdict — the sender should renegotiate)."""
    wire, cc = _framed_wire()
    wire[0, 2] = 99
    return frames.check_frame_row(wire, cc, "mutant")


def frame_header_mismatch() -> List[Diagnostic]:
    """Sender framed at 4 bits, receiver expects the 8-bit layout: the
    header/config disagreement must be typed, never a garbage decode."""
    wire, cc = _framed_wire()
    return frames.check_frame_row(wire, cc.with_bits(8), "mutant")


def frame_partial_checksum() -> List[Diagnostic]:
    """CRC computed over the payload only (a sender that skips the
    header): coverage check must reject — otherwise corrupt header
    bytes would slip through checksum-"valid" frames."""
    from repro_torch.core import frame
    wire, cc = _framed_wire()
    bad = frame.crc32c(wire[0, 16:])
    wire[0, 12:16] = np.asarray([bad], "<u4").view(np.uint8)
    return frames.check_frame_row(wire, cc, "mutant")


# ---------------------------------------------------------------------------
# the card's budget (in place of the JAX package's VMEM mutants)
# ---------------------------------------------------------------------------

def _table(source: str):
    return [k for k in smem.INSTANCES if k.source == source]


def smem_overflow() -> List[Diagnostic]:
    """A CRC tile ring of four stages in place of two: 313 KB of dynamic
    shared memory a block, past the H100's 227 KB."""
    k = [i for i in _table("crc.cu") if i.kernel == "crc_tiles<true>"][0]
    return smem.check_instances(
        [k._replace(dynamic_smem=k.dynamic_smem + 2 * 68 * 1024)],
        smem.H100)


def threads_overflow() -> List[Diagnostic]:
    """A wire encode launched with 2048 threads a block."""
    return smem.check_instances(
        [_table("wire.cu")[0]._replace(threads=2048)], smem.H100)


def regs_overflow() -> List[Diagnostic]:
    """fc_ar built at 96 registers a thread: three blocks of 256 threads
    (its __launch_bounds__) would need 73728 registers of a
    multiprocessor's 65536."""
    ks = _table("allreduce.cu")
    attrs = {"allreduce.cu": [smem.Attrs(k.threads, 96, 8192, 0, 0)
                              for k in ks]}         # 8192: part[kTile]
    return smem.check_attrs(attrs, smem.H100, ks)[0]


def attrs_mismatch() -> List[Diagnostic]:
    """A built crc_rows whose ``__launch_bounds__`` says 256 threads where
    its wrapper launches 128: the table no longer describes what runs."""
    ks = _table("crc.cu")
    attrs = {"crc.cu": [
        smem.Attrs(256 if k.kernel == "crc_rows" else k.threads, 32, 0, 0,
                   0)
        for k in ks]}
    return smem.check_attrs(attrs, smem.H100, ks)[0]


def static_smem_overflow() -> List[Diagnostic]:
    """fc_ar built with a 128 KB static array beside its three resident
    blocks (its __launch_bounds__): 384 KB a multiprocessor of 228 KB."""
    ks = _table("allreduce.cu")
    attrs = {"allreduce.cu": [smem.Attrs(k.threads, 32, 128 * 1024, 0, 0)
                              for k in ks]}
    return smem.check_attrs(attrs, smem.H100, ks)[0]


def no_resident_grid() -> List[Diagnostic]:
    """An occupancy query that finds no resident block for 16 ranks on
    one card: the cooperative grid's spin waits would never end."""
    return smem.check_residency(
        [smem.fused_mode(CommConfig(), "tp")], 16,
        blocks_per_rank=lambda key, dev, ranks: 0, subject="mutant")


def peermem_overflow() -> List[Diagnostic]:
    """qwen3-14b's train_4k at --mesh 1,16 with the 16 ranks on one
    80 GB card: each rank's model world holds 1.3 GB receive rows."""
    from repro_torch.configs import get_config
    from repro_torch.parallel.plan import make_plan
    cfg = get_config("qwen3-14b")
    plan = make_plan(cfg, tp=16, fsdp=1)
    worlds = smem.peer_worlds(cfg, plan, {"data": 1, "model": 16},
                              global_batch=256, seq=4096, mode="train")
    return smem.check_peer_memory(worlds, 16, smem.H100, "mutant")


def peermem_a2a_overflow() -> List[Diagnostic]:
    """An oversized MoE dispatch (moonshot's prefill_32k at ep = 16): the
    peer worlds of 16 ranks overflow one card."""
    from repro_torch.configs import get_config
    from repro_torch.parallel.plan import make_plan
    cfg = get_config("moonshot-v1-16b-a3b")
    plan = make_plan(cfg, tp=16, fsdp=1)
    worlds = smem.peer_worlds(cfg, plan, {"data": 1, "model": 16},
                              global_batch=32, seq=32768, mode="prefill")
    return smem.check_peer_memory(worlds, 16, smem.H100, "mutant")


def codec_group16() -> List[Diagnostic]:
    """Group 16 at a CUDA codec launch: no kernel takes it."""
    return smem.check_codec_launch(CommConfig(bits=8, group=16), 4, 4096,
                                   "mutant")


def fused_group16() -> List[Diagnostic]:
    """Group 16 under the fused scheme at tp = 2: fc_ar has no
    instantiation for it."""
    return smem.check_fused_site(
        CommConfig(bits=8, group=16, scheme="fused"), "tp", 2, 1, "mutant")


# ---------------------------------------------------------------------------
# site mutants (broken policies against a real model config)
# ---------------------------------------------------------------------------

def _model_cfg():
    from repro_torch.configs import get_config
    return get_config("moonshot-v1-16b-a3b")      # has moe blocks


def unresolvable_site() -> List[Diagnostic]:
    """depth_interp ending at 9 bits: mid-stack layers resolve to an
    unsupported width."""
    from repro_torch.core.policy import CommPolicy, depth_interp
    pol = CommPolicy(tp=depth_interp(CommConfig(bits=8), 8, 9))
    return sites.check_policy_sites(_model_cfg(), pol, "mutant")


def bad_a2a_scheme() -> List[Diagnostic]:
    """Hierarchical schedule at the single-hop MoE dispatch."""
    from repro_torch.core.policy import CommPolicy
    pol = CommPolicy(a2a=CommConfig(bits=4, group=32,
                                    scheme="hierarchical"))
    return sites.check_policy_sites(_model_cfg(), pol, "mutant")


def ef_without_grad() -> List[Diagnostic]:
    """grad_ef with the grad site exact: dead EF residual."""
    from repro_torch.core.policy import CommPolicy
    pol = CommPolicy(grad=None, grad_ef=True)
    return sites.check_policy_sites(_model_cfg(), pol, "mutant")


def ef_with_nccl_qgrad() -> List[Diagnostic]:
    """grad_ef with grad dead AND qgrad_rs resolving to the exact nccl
    scheme: neither residual consumer exists, SITE-EF must still fire
    (the qgrad extension must not let an exact qgrad site satisfy it)."""
    from repro_torch.core.policy import CommPolicy
    pol = CommPolicy(grad=None, grad_ef=True,
                     qgrad_rs=CommConfig(bits=4, group=32, scheme="nccl"))
    return sites.check_policy_sites(_model_cfg(), pol, "mutant")


def bad_qgrad_scheme() -> List[Diagnostic]:
    """Fused schedule at the qgrad reduce-scatter: the gather/scatter
    sites are codec-wrapped library collectives with no fused kernel."""
    from repro_torch.core.policy import CommPolicy
    pol = CommPolicy(qgrad_rs=CommConfig(bits=4, group=32,
                                         scheme="fused"))
    return sites.check_policy_sites(_model_cfg(), pol, "mutant")


def qgrad_misaligned() -> List[Diagnostic]:
    """A qgrad group size that no per-rank gradient shard of the model
    is a multiple of: every parameter pads on the wire — exactly where
    the old in-VJP path silently fell back to the exact psum_scatter."""
    from repro_torch.core.policy import CommPolicy
    from repro_torch.parallel.plan import make_plan
    cfg = _model_cfg()
    plan = make_plan(cfg, tp=2, fsdp=2)
    pol = CommPolicy(qgrad_rs=CommConfig(bits=8, group=768))
    return sites.check_qgrad_alignment(cfg, plan, pol, "mutant")


# ---------------------------------------------------------------------------
# the registry + runner
# ---------------------------------------------------------------------------

#: fixture name -> (builder, rule that MUST fire)
FIXTURES: Dict[str, Tuple[Callable[[], List[Diagnostic]], str]] = {
    "deadlock_wait_before_push": (deadlock_wait_before_push,
                                  "CHOREO-DEADLOCK"),
    "deadlock_barrier_overwait": (deadlock_barrier_overwait,
                                  "CHOREO-DEADLOCK"),
    "slot_mismatch_shared_recv": (slot_mismatch_shared_recv,
                                  "CHOREO-SLOT"),
    "sem_self_signal": (sem_self_signal, "CHOREO-SEM"),
    "race_no_barrier": (race_no_barrier, "CHOREO-RACE"),
    "race_read_before_wait": (race_read_before_wait, "CHOREO-RACE"),
    "bounds_bad_row": (bounds_bad_row, "CHOREO-BOUNDS"),
    "bounds_bad_slot": (bounds_bad_slot, "CHOREO-BOUNDS"),
    "id_collision": (id_collision, "CHOREO-ID"),
    "push_into_readonly": (push_into_readonly, "CHOREO-RACE"),
    "layout_overlap": (layout_overlap, "LAYOUT-OVERLAP"),
    "layout_gap": (layout_gap, "LAYOUT-GAP"),
    "layout_bounds": (layout_bounds, "LAYOUT-BOUNDS"),
    "layout_undercover": (layout_undercover, "LAYOUT-GAP"),
    "spike_group_overflow": (spike_group_overflow, "LAYOUT-SPIKEIDX"),
    "frame_bad_version": (frame_bad_version, "FRAME-VERSION"),
    "frame_header_mismatch": (frame_header_mismatch, "FRAME-HEADER"),
    "frame_partial_checksum": (frame_partial_checksum, "FRAME-COVERAGE"),
    "smem_overflow": (smem_overflow, "CARD-SMEM"),
    "peermem_a2a_overflow": (peermem_a2a_overflow, "CARD-PEERMEM"),
    "threads_overflow": (threads_overflow, "CARD-THREADS"),
    "regs_overflow": (regs_overflow, "CARD-REGS"),
    "attrs_mismatch": (attrs_mismatch, "CARD-ATTRS"),
    "static_smem_overflow": (static_smem_overflow, "CARD-SMEM"),
    "no_resident_grid": (no_resident_grid, "CARD-RESIDENT"),
    "peermem_overflow": (peermem_overflow, "CARD-PEERMEM"),
    "codec_group16": (codec_group16, "CARD-CODEC"),
    "fused_group16": (fused_group16, "SITE-FUSED-MESH"),
    "unresolvable_site": (unresolvable_site, "SITE-RESOLVE"),
    "bad_a2a_scheme": (bad_a2a_scheme, "SITE-SCHEME"),
    "ef_without_grad": (ef_without_grad, "SITE-EF"),
    "ef_with_nccl_qgrad": (ef_with_nccl_qgrad, "SITE-EF"),
    "bad_qgrad_scheme": (bad_qgrad_scheme, "SITE-SCHEME"),
    "qgrad_misaligned": (qgrad_misaligned, "SITE-QGRAD-ALIGN"),
}


def run_selftest() -> Tuple[List[str], List[str]]:
    """Run every fixture; returns (passed, failed) fixture names, where
    failure means the expected rule did NOT fire."""
    passed, failed = [], []
    for name, (fn, rule) in FIXTURES.items():
        diags = fn()
        if any(d.rule == rule for d in diags):
            passed.append(name)
        else:
            fired = sorted({d.rule for d in diags})
            failed.append(f"{name} (wanted {rule}, fired {fired})")
    return passed, failed
