"""The peer-push All2All (``repro_torch.kernels.rdma``) on the CPU.

The kernel itself runs only on the card (``chip_smoke.py`` phase ``a2a``
holds it against its plain version there). Here:

* the plain version equals the JAX package's semantics, the codec of
  ``repro.core.codec`` around an all-to-all of the blocks, byte for byte
  (receive buffers) and bit for bit (outputs);
* the port's protocol declarations equal the JAX package's, field by
  field, and a loopback world is sized from them;
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
