"""The peer-push All2All (``repro_torch.kernels.rdma``) on the CPU.

The kernel itself runs only on the card (``chip_smoke.py`` phase ``a2a``
holds it against its plain version there). Here:

* the plain version equals the JAX package's semantics, the codec of
  ``repro.core.codec`` around an all-to-all of the blocks, byte for byte
  (receive buffers) and bit for bit (outputs);
* the port's protocol declarations equal the JAX package's, field by
  field, and a loopback world is sized from them;
* ``fc_a2a``'s grid is sized by each call's work and agreed by every
  rank, and the pads' running targets are what the device code adds,
  call by call;
* the wrapper's refusals, and the dispatch of ``ops.fused_all_to_all``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core.comm_config import CommConfig as JConfig
from repro.kernels import protocol as jprotocol
from repro_torch.core.comm_config import CommConfig
from repro_torch.kernels import ops, protocol, rdma
from _torch_threads import one_torch_thread  # noqa: E402,F401

CFGS = {"int4 g32": dict(bits=4, group=32),
        "int4 g32 scale_int": dict(bits=4, group=32, scale_int=True),
        "int2 g32 spike": dict(bits=2, group=32, spike=True)}


def _payload(tp: int, m: int, d: int, dtype) -> torch.Tensor:
    rng = np.random.default_rng(tp)
    x = (rng.standard_normal((tp, tp, m, d)) * 2).astype(np.float32)
    x[0, tp - 1, 0, 3] = 50.0
    x[tp - 1, 0, m - 1, 9] = -0.0
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16])
@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("tp", [2, 4])
def test_plain_loopback_equals_jax(tp, name, dtype):
    """Rank r's receive row j is rank j's encoded block r, and its output
    block j that row decoded into the payload dtype (JAX's eager codec,
    a bf16 payload encoded as its float32 cast)."""
    m, d = 3, 128
    x = _payload(tp, m, d, dtype)
    out, recv = rdma.fused_all_to_all_rdma_plain(x, CommConfig(**CFGS[name]))
    jc = JConfig(backend="ref", **CFGS[name])
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xj = jnp.asarray(x.float().numpy()).astype(jdt)
    wire = np.asarray(jcodec.encode(xj, jc))            # [sender, dest]
    want_recv = wire.transpose(1, 0, 2, 3)              # [receiver, sender]
    want = np.asarray(jcodec.decode(jnp.asarray(want_recv), jc, d,
                                    out_dtype=jdt))
    assert recv.shape == (tp, tp, m * jc.wire_bytes(d))
    np.testing.assert_array_equal(recv.numpy(),
                                  want_recv.reshape(tp, tp, -1))
    view = (torch.int16, np.int16) if dtype == torch.bfloat16 else \
        (torch.int32, np.int32)
    np.testing.assert_array_equal(out.view(view[0]).numpy(),
                                  want.view(view[1]))


@pytest.mark.parametrize("tp", range(2, 17))
def test_protocol_equals_jax(tp):
    for fn in ("allreduce_scatter_protocol", "allreduce_gather_protocol",
               "all2all_protocol"):
        got, want = getattr(protocol, fn)(tp), getattr(jprotocol, fn)(tp)
        assert got._asdict().keys() == want._asdict().keys()
        for field in want._fields:
            assert tuple(getattr(got, field)) == tuple(getattr(want, field)) \
                if isinstance(getattr(want, field), tuple) else \
                getattr(got, field) == getattr(want, field), (fn, field)
    assert [p.collective_id for p in protocol.live_protocols(tp)] == \
        [p.collective_id for p in jprotocol.live_protocols(tp)]
    assert (protocol.A2A_COLLECTIVE_ID, protocol.resolve_row("dst", 1, 2),
            protocol.resolve_row("my", 1, 2)) == (
        jprotocol.A2A_COLLECTIVE_ID, 2, 1)


@pytest.mark.parametrize("tp", [1, 2, 4, 8, 16])
def test_loopback_world_sizing(tp):
    """Every rank gets, for each live protocol, the protocol's ``recv``
    rows of ``row_bytes`` and a pad of barrier + ``sem_slots`` receive
    slots + the local slot, all zero, in one allocation, no two regions
    overlapping; the peer table of a protocol carries its buffers, pads,
    barrier offsets and push plan."""
    w = rdma.PeerWorld.loopback(tp, 1000, "cpu")
    protos = protocol.live_protocols(tp)
    assert sorted(w.protocols) == sorted(p.collective_id for p in protos)
    spans = []
    for proto in protos:
        cid = proto.collective_id
        assert rdma.signal_words(proto) == tp + 1
        for r in range(tp):
            assert w.recv_rows(r, cid).shape == (proto.buffer("recv").rows,
                                                 1000)
            assert w.signal_pad(r, cid).tolist() == [0] * (tp + 1)
            spans.append((w.recv[cid][r], proto.buffer("recv").rows * 1000))
            spans.append((w.signal[cid][r], 4 * (tp + 1)))
    spans.sort()
    assert all(a + n <= b for (a, n), (b, _) in zip(spans, spans[1:]))
    assert spans[-1][0] + spans[-1][1] <= w.storage.data_ptr() + \
        w.storage.numel()
    assert not w.storage.any()
    for proto in protos:
        cid = proto.collective_id
        tab = w.table(cid, m=3, in_kind=1)
        head = tab[:rdma.PEER_HEAD].tolist()
        assert head == [tp, tp, 0, 3, 1000, 0, 1, tp - 1, tp - 1, tp - 1,
                        tp - 1, 0, 0, 0, 0]
        cols = tab[rdma.PEER_HEAD:].reshape(5, rdma.MAX_PEERS)
        assert cols[0, :tp].tolist() == w.recv[cid]
        assert cols[1, :tp].tolist() == w.signal[cid]
        assert cols[2, :tp - 1].tolist() == list(
            proto.barrier.signal_offsets)
        assert cols[3, :tp - 1].tolist() == [s.dst_off for s in proto.pushes]
        assert cols[4, :tp - 1].tolist() == [s.recv_slot
                                             for s in proto.pushes]


#: the modes of fc_a2a's instantiations (CFGS and the rotating one)
MODES = {**CFGS, "int2 g32 rotation": dict(bits=2, group=32, rotation=True)}
A2A = protocol.A2A_COLLECTIVE_ID


def _rank_world(tp: int, rank: int, caps) -> rdma.PeerWorld:
    """Rank ``rank``'s view of a world of processes (one rank a process,
    as ``PeerWorld.from_group`` builds it; addresses only, no memory),
    with the caps the world agreed on."""
    w = rdma.PeerWorld(tp, 1, rank, protocol.live_protocols(tp),
                       [(r + 1) << 20 for r in range(tp)], 1 << 16, "cpu")
    w.caps = dict(caps)
    return w


def _moonshot_rows(tp: int):
    """Rows a rank sends each peer at moonshot's dispatch with ep = tp
    (batch 4 x prompt 128): (E / tp) experts x capacity 64 at prefill,
    x capacity 1 at decode."""
    return {"prefill": 64 // tp * 64, "decode": 64 // tp}


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_a2a_blocks_sized_by_the_work(tp):
    """Every rank of a world computes one block count for a call from
    (tp, m, d, cfg, dtype) and the world's caps, whatever its rank: one
    block for each A2A_THREADS items of eight values of the rank's
    tp * m rows, at most the cap of the instantiation (mode and payload
    type). Moonshot's decode dispatch takes 64 blocks of 256 a rank at
    every tp (16,384 items); its prefill dispatch fills the cap."""
    for scale in (1, 4):
        caps = {k: scale * (49 if k[3] else 66 + k[4]) for k in
                rdma.A2A_MODES}
        worlds = [_rank_world(tp, r, caps) for r in range(tp)]
        for name, kw in MODES.items():
            cfg = CommConfig(**kw)
            for dtype in (torch.bfloat16, torch.float32):
                cap = caps[rdma.a2a_mode(cfg, dtype)]
                for m, d in ((1, 32), (3, 96), (1, 2048), (16, 2048),
                             (1024, 2048), (7, 4096)):
                    counts = {w.a2a_blocks(m, d, cfg, dtype) for w in worlds}
                    items = tp * m * d // rdma.A2A_PER
                    assert counts == {min(cap, -(-items // rdma.A2A_THREADS))
                                      }, (name, m, d, counts)
                rows = _moonshot_rows(tp)
                dec, pre = (worlds[0].a2a_blocks(rows[k], 2048, cfg, dtype)
                            for k in ("decode", "prefill"))
                assert (dec, pre) == (min(64, cap), cap), (name, dec, pre)


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_a2a_pad_targets_after_mixed_calls(tp):
    """After fc_a2a calls of moonshot's prefill and decode dispatch in
    every mode and both payload types (so grids of different sizes), the
    running targets are what the device code adds to every rank's pad:
    each block of a rank signals the barrier of each peer at the
    protocol's offsets, its push step's slot at each peer and the rank's
    local slot. Each call's table carries its grid and the targets after
    it; a world of processes fences at system scope."""
    caps = {k: 40 + i for i, k in enumerate(rdma.A2A_MODES)}
    w = _rank_world(tp, tp - 1, caps)
    proto = w.protocols[A2A]
    pads = [[0] * (tp + 1) for _ in range(tp)]
    grids = []
    for i, (name, kw) in enumerate(list(MODES.items()) * 2):
        cfg = CommConfig(**kw)
        dtype = (torch.bfloat16, torch.float32)[i % 2]
        for m in _moonshot_rows(tp).values():
            blocks, tab = w.a2a_call(m, 2048, cfg, dtype)
            grids.append(blocks)
            for my in range(tp):
                for _ in range(blocks):
                    for off in proto.barrier.signal_offsets:
                        pads[(my + off) % tp][0] += 1
                    for st in proto.pushes:
                        pads[(my + st.dst_off) % tp][1 + st.recv_slot] += 1
                pads[my][1 + proto.sem_slots] += blocks
            head = tab[:rdma.PEER_HEAD].tolist()
            assert head[:7] == [tp, 1, tp - 1, m, 1 << 16, blocks,
                                int(dtype == torch.bfloat16)]
            assert head[11:14] == w.targets[A2A] and head[14] == 0
    assert len(set(grids)) >= 3
    assert w.epochs[A2A] == len(grids)
    for r in range(tp):
        assert pads[r] == w.pad_targets(A2A), r
    assert w.pad_targets(A2A) == [sum(grids) * (tp - 1)] + \
        [sum(grids)] * tp


def test_a2a_loopback_fences_on_one_card():
    """A loopback world (every rank on one card) flags its tables so that
    the kernels fence at gpu scope."""
    cfg = CommConfig(bits=4, group=32)
    w = rdma.PeerWorld.loopback(2, 4096, "cpu")
    w.caps = {k: 8 for k in rdma.cap_keys(w.protocols.values())}
    blocks, tab = w.a2a_call(3, 64, cfg, torch.bfloat16)
    assert blocks == 1 and tab[14] == rdma.FLAG_ONE_CARD


def test_wrapper_refuses():
    cfg = CommConfig(bits=4, group=32)
    w = rdma.PeerWorld.loopback(2, 4 * cfg.wire_bytes(64), "cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        rdma.fused_all_to_all_rdma(torch.zeros(2, 2, 4, 64), cfg, w)
    with pytest.raises(ValueError, match="not a multiple"):
        rdma.fused_all_to_all_rdma(torch.zeros(2, 2, 4, 48), cfg, w)
    with pytest.raises(ValueError, match="contiguous"):
        rdma.fused_all_to_all_rdma(torch.zeros(1, 2, 4, 64), cfg, w)
    for dtype in (torch.int32, torch.float16):
        with pytest.raises(TypeError, match="dtype"):
            rdma.fused_all_to_all_rdma(torch.zeros(2, 2, 4, 64, dtype=dtype),
                                       cfg, w)
    with pytest.raises(NotImplementedError):
        rdma.fused_all_to_all_rdma(torch.zeros(2, 2, 4, 64),
                                   dataclasses.replace(cfg, group=16), w)


def test_ops_dispatch():
    """A PeerWorld goes to the peer-push wrapper (which refuses a CPU
    tensor rather than fall back); None runs the emulated schedule, which
    equals the plain loopback on one rank."""
    cfg = CommConfig(bits=4, group=32)
    x = _payload(1, 3, 64, torch.bfloat16)
    w = rdma.PeerWorld.loopback(1, 3 * cfg.wire_bytes(64), "cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.fused_all_to_all(x, cfg, w)
    got = ops.fused_all_to_all(x[0], cfg, None)
    want, _ = rdma.fused_all_to_all_rdma_plain(x, cfg)
    assert torch.equal(got.view(torch.int16), want[0].view(torch.int16))
