"""The fused two-step AllReduce (``repro_torch.kernels.rdma``) on the CPU.

The phase kernels (``csrc/allreduce.cu``) run only on the card
(``chip_smoke.py`` phases ``ar`` and ``tp`` hold them against the plain
version there). Here, for tp in {2, 4, 8} and the three configs of phase
``ar``:

* the plain version equals a replay of the JAX schedule with the JAX
  package's eager codec: byte for byte in both phases' receive rows, bit
  for bit in the output;
* on each of tp gloo ranks it equals the port's ``quantized_all_reduce``
  under ``two_step`` and under the emulated ``fused``;
* a :class:`PeerWorld` is sized per protocol, with its pads and epochs
  kept apart by ``collective_id``; ``fc_ar``'s grid is sized by each
  call's work and agreed by every rank, and the pads' running targets are
  what the device code adds, call by call, with ``fc_a2a``'s calls
  between them;
* the wrapper's refusals, and the dispatch of ``ops.fused_all_reduce``.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core.comm_config import CommConfig as JConfig
from repro_torch.core.comm_config import CommConfig
from repro_torch.kernels import ops, protocol, rdma

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_gloo_worker as worker  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

CFGS = {"int8 g128": dict(bits=8, group=128),
        "int5 g128 scale_int": dict(bits=5, group=128, scale_int=True),
        "int2 g32 spike": dict(bits=2, group=32, spike=True)}
SCATTER = protocol.ALLREDUCE_SCATTER_COLLECTIVE_ID
GATHER = protocol.ALLREDUCE_GATHER_COLLECTIVE_ID


def _inputs(tp: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(40 + tp)
    x = (rng.standard_normal((tp, n)) * 2).astype(np.float32)
    x[0, 3] = 45.0
    x[tp - 1, n - 1] = -30.0
    x[tp // 2, n // 2] = -0.0
    return x


_ROWS = 64          # every replay's rows, zero-padded: one JAX trace a config


def _enc(rows: np.ndarray, jc: JConfig) -> np.ndarray:
    """(R, chunk) -> (R, wb) with the JAX package's eager codec."""
    pad = np.zeros((_ROWS, rows.shape[1]), np.float32)
    pad[:len(rows)] = rows
    return np.asarray(jcodec.encode(jnp.asarray(pad), jc))[:len(rows)]


def _dec(rows: np.ndarray, jc: JConfig, chunk: int) -> np.ndarray:
    pad = np.zeros((_ROWS, rows.shape[1]), np.uint8)
    pad[:len(rows)] = rows
    return np.asarray(jcodec.decode(jnp.asarray(pad), jc, chunk))[:len(rows)]


def _replay(x: np.ndarray, jc: JConfig):
    """The JAX schedule over tp ranks in one process, eager JAX codec:
    encode (tp, chunk) on every rank, transpose, decode, sum in row order
    from +0.0, re-encode, gather, decode -> (out, scatter_recv,
    gather_recv)."""
    tp, n = x.shape
    chunk = n // tp
    sent = _enc(x.reshape(tp * tp, chunk), jc).reshape(tp, tp, -1)
    scatter = sent.transpose(1, 0, 2)                     # [receiver, sender]
    parts = _dec(scatter.reshape(tp * tp, -1), jc, chunk).reshape(
        tp, tp, chunk)
    partial = np.zeros((tp, chunk), np.float32)
    for j in range(tp):
        partial = partial + parts[:, j]
    sent2 = _enc(partial, jc)                             # (tp, wb)
    gather = np.broadcast_to(sent2[None], (tp,) + sent2.shape)
    out = _dec(sent2, jc, chunk).reshape(1, n)
    return np.broadcast_to(out, (tp, n)), scatter, gather


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("tp", [2, 4, 8])
def test_plain_equals_jax_replay(tp, name):
    x = _inputs(tp, tp * 256)
    out, scatter, gather = rdma.fused_all_reduce_rdma_plain(
        torch.from_numpy(x), CommConfig(**CFGS[name]))
    want_out, want_scatter, want_gather = _replay(
        x, JConfig(backend="ref", **CFGS[name]))
    np.testing.assert_array_equal(scatter.numpy(), want_scatter)
    np.testing.assert_array_equal(gather.numpy(), want_gather)
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  want_out.view(np.uint32))


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_plain_equals_gloo_ranks(tp, tmp_path):
    """tp gloo ranks (``tests/_torch_gloo_worker.py``) all-reduce their
    rows with ``quantized_all_reduce`` under two_step and the emulated
    fused; each rank's result is the plain version's, bit for bit."""
    script = os.path.join(os.path.dirname(__file__), "_torch_gloo_worker.py")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, script, str(r), str(tp),
                               str(tmp_path / "store"), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=env)
             for r in range(tp)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0].decode())
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    x = torch.from_numpy(worker.inputs(tp))
    for name, kw in worker.CONFIGS.items():
        want = rdma.fused_all_reduce_rdma_plain(x, CommConfig(**kw))[0]
        for r in range(tp):
            res = np.load(tmp_path / f"rank{r}.npz")
            for scheme in ("two_step", "fused"):
                np.testing.assert_array_equal(
                    res[f"{name}_{scheme}"].view(np.uint32),
                    want[r].numpy().view(np.uint32),
                    err_msg=f"rank {r} {name} {scheme}")


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_world_sized_per_protocol(tp):
    """The AllReduce's two phases each get tp receive rows of row_bytes
    and a pad of tp + 1 counters a rank, apart from each other; each
    phase's peer table points at its own buffers and pads, and counts its
    own calls. One fc_ar call gives both tables the call's grid and
    each its own targets."""
    protos = rdma.ar_protocols(tp)
    w = rdma.PeerWorld.loopback(tp, 1000, "cpu", protocols=protos)
    assert sorted(w.protocols) == [SCATTER, GATHER]
    offs, rank_bytes = rdma.rank_layout(protos, 1000)
    assert rank_bytes * tp == w.storage.numel()
    (r0, p0), (r1, p1) = offs[SCATTER], offs[GATHER]
    assert r0 + tp * 1000 <= p0 < p0 + 4 * (tp + 1) <= r1
    assert r1 + tp * 1000 <= p1 < p1 + 4 * (tp + 1) <= rank_bytes
    for r in range(tp):
        for cid in (SCATTER, GATHER):
            assert w.recv_rows(r, cid).shape == (tp, 1000)
            assert w.signal_pad(r, cid).tolist() == [0] * (tp + 1)
        assert w.signal[SCATTER][r] != w.signal[GATHER][r]
    with pytest.raises(KeyError):
        w.recv_rows(0, protocol.A2A_COLLECTIVE_ID)
    cfg = CommConfig(**CFGS["int8 g128"])
    w.caps = dict.fromkeys(rdma.AR_MODES, 3)        # the caps of the grid
    for n in (tp * 128, tp * 128):                  # 1 tile a chunk
        blocks, ts, tg = w.ar_call(n, cfg)
    assert blocks == min(3, tp)
    assert w.epochs == {SCATTER: 2, GATHER: 2}
    head = [tp, tp, 0, 0, 1000, blocks, 0, tp - 1, tp - 1, tp - 1, tp - 1]
    assert ts[:11].tolist() == head and tg[:11].tolist() == head
    # targets after two calls of `blocks` blocks, every block signalling;
    # the gather phase runs no barrier; flags: one card (loopback)
    assert rdma.PEER_HEAD == 15
    assert ts[11:15].tolist() == [2 * (tp - 1) * blocks, 2 * blocks,
                                  2 * blocks, rdma.FLAG_ONE_CARD]
    assert tg[11:15].tolist() == [0, 2 * blocks, 2 * blocks,
                                  rdma.FLAG_ONE_CARD]
    for cid, tab in ((SCATTER, ts), (GATHER, tg)):
        cols = tab[rdma.PEER_HEAD:].reshape(5, rdma.MAX_PEERS)
        assert cols[0, :tp].tolist() == w.recv[cid]
        assert cols[1, :tp].tolist() == w.signal[cid]


def _rank_world(tp: int, rank: int, caps) -> rdma.PeerWorld:
    """Rank ``rank``'s view of a world of processes (one rank a process,
    as ``PeerWorld.from_group`` builds it; addresses only, no memory),
    with the caps the world agreed on."""
    w = rdma.PeerWorld(tp, 1, rank, protocol.live_protocols(tp),
                       [(r + 1) << 20 for r in range(tp)], 4096, "cpu")
    w.caps = dict(caps)
    return w


QWEN_SHAPES = {"prefill": 4 * 128 * 5120, "decode": 4 * 5120}


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_ar_blocks_sized_by_the_work(tp):
    """Every rank of a world computes one block count for a call from
    (n, tp, cfg) and the world's caps, whatever its rank: one block for
    each tile of AR_TILE values of the tp chunk rows, at most the cap of
    the config's instantiation. qwen3-14b's decode site takes fewer
    blocks than its prefill site, which fills the cap."""
    for scale in (1, 4):
        caps = {m: scale * (66 if m[2] else 132) for m in rdma.AR_MODES}
        worlds = [_rank_world(tp, r, caps) for r in range(tp)]
        for name, kw in CFGS.items():
            cfg = CommConfig(**kw)
            cap = caps[rdma.ar_mode(cfg)]
            for n in (*QWEN_SHAPES.values(), tp * 128, tp * 2048,
                      tp * 2176):
                counts = {w.ar_blocks(n, cfg) for w in worlds}
                tiles = -(-(n // tp) // rdma.AR_TILE)
                assert counts == {min(cap, tp * tiles)}, (name, n, counts)
            dec, pre = (worlds[0].ar_blocks(QWEN_SHAPES[k], cfg)
                        for k in ("decode", "prefill"))
            assert dec == tp * -(-5120 * 4 // tp // rdma.AR_TILE) < pre == cap
    rot = CommConfig(bits=2, group=32, rotation=True)
    assert worlds[0].ar_blocks(QWEN_SHAPES["prefill"], rot) == 4 * 66


def _simulated_pads(tp: int, protos, calls):
    """The counters peer.cuh adds to every rank's pads in ``calls``, each
    (collective ids with their barrier flag, blocks a rank), every block
    signalling: barrier signals to each peer at signal_offsets, one push
    signal to each push step's slot, one local signal."""
    pads = {cid: [[0] * (tp + 1) for _ in range(tp)] for cid in protos}
    for phases, blocks in calls:
        for cid, barrier in phases:
            proto = protos[cid]
            for my in range(tp):
                for _ in range(blocks):
                    if barrier:
                        for off in proto.barrier.signal_offsets:
                            pads[cid][(my + off) % tp][0] += 1
                    for st in proto.pushes:
                        dst = (my + st.dst_off) % tp
                        pads[cid][dst][1 + st.recv_slot] += 1
                pads[cid][my][1 + proto.sem_slots] += blocks
    return pads


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("tp", [2, 4, 8])
def test_pad_targets_after_mixed_calls(tp, name):
    """After fc_ar calls of different sizes (so different grids) with
    fc_a2a calls of different sizes between them (grids of their own,
    also sized by the work), each protocol's targets are what the device
    code adds to every rank's pad, counted call by call."""
    cap = 40
    cfg = CommConfig(**CFGS[name])
    acfg = CommConfig(bits=4, group=32)
    w = _rank_world(tp, tp - 1, {k: cap for k in rdma.cap_keys(
        protocol.live_protocols(tp))})
    ar = ((SCATTER, True), (GATHER, False))
    a2a = ((protocol.A2A_COLLECTIVE_ID, True),)
    calls = []
    for kind, size in (("ar", QWEN_SHAPES["decode"]),
                       ("ar", QWEN_SHAPES["prefill"]), ("ar", tp * 128),
                       ("a2a", 1), ("ar", QWEN_SHAPES["decode"]),
                       ("a2a", 1024), ("ar", QWEN_SHAPES["prefill"]),
                       ("a2a", 4)):
        if kind == "a2a":             # m rows of moonshot's 2048 a peer
            blocks, _ = w.a2a_call(size, 2048, acfg, torch.bfloat16)
            calls.append((a2a, blocks))
        else:
            blocks, _, _ = w.ar_call(size, cfg)
            calls.append((ar, blocks))
    assert len({c[1] for c in calls}) >= 4          # four grid sizes
    pads = _simulated_pads(tp, w.protocols, calls)
    for cid in w.protocols:
        for r in range(tp):
            assert pads[cid][r] == w.pad_targets(cid), (cid, r)
    a2a_blocks = sum(b for phases, b in calls if phases is a2a)
    assert w.pad_targets(protocol.A2A_COLLECTIVE_ID) == \
        [a2a_blocks * (tp - 1)] + [a2a_blocks] * tp
    assert w.pad_targets(GATHER)[0] == 0
    _, ts, tg = w.ar_call(QWEN_SHAPES["decode"], cfg)
    assert ts[14] == tg[14] == 0                    # not one card
    assert ts[11:14].tolist() == w.targets[SCATTER]
    assert tg[11:14].tolist() == w.targets[GATHER]


def test_wrapper_refuses():
    cfg = CommConfig(bits=8, group=128)
    w = rdma.PeerWorld.loopback(2, cfg.wire_bytes(256), "cpu",
                                protocols=rdma.ar_protocols(2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        rdma.fused_all_reduce_rdma(torch.zeros(2, 512), cfg, w)
    with pytest.raises(ValueError, match="not a multiple"):
        rdma.fused_all_reduce_rdma(torch.zeros(2, 384), cfg, w)
    with pytest.raises(ValueError, match="exceeds"):
        rdma.fused_all_reduce_rdma(torch.zeros(2, 1024), cfg, w)
    with pytest.raises(ValueError, match="contiguous"):
        rdma.fused_all_reduce_rdma(torch.zeros(512), cfg, w)
    with pytest.raises(TypeError, match="float32"):
        rdma.fused_all_reduce_rdma(torch.zeros(2, 512, dtype=torch.bfloat16),
                                   cfg, w)
    a2a_only = rdma.PeerWorld.loopback(
        2, cfg.wire_bytes(256), "cpu",
        protocols=(protocol.all2all_protocol(2),))
    with pytest.raises(ValueError, match="collective id"):
        a2a_only._protocol(SCATTER, "fused_all_reduce_rdma")
    with pytest.raises(ValueError, match="CUDA device"):
        rdma.PeerWorld.from_group(None, 0, 1000, device="cpu")


def test_ops_dispatch():
    """A world goes to the peer-push wrapper (which refuses a CPU tensor
    rather than fall back); None runs the emulated schedule, which equals
    the plain version on one rank."""
    cfg = CommConfig(bits=5, group=128, scale_int=True)
    x = torch.from_numpy(_inputs(1, 512))
    for tp in (1, 2):
        world = rdma.PeerWorld.loopback(tp, 4096, "cpu")
        with pytest.raises(ValueError, match="CUDA tensor"):
            ops.fused_all_reduce(x.expand(tp, 512).contiguous(), cfg, world)
    want = rdma.fused_all_reduce_rdma_plain(x, cfg)[0][0]
    got = ops.fused_all_reduce(x[0], cfg, None)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))



def test_fused_sites_pick_world_or_group(monkeypatch):
    """``quantized_all_reduce``'s choice for the ``fused`` scheme: a model
    axis with a peer world sends the site to the kernels; a CPU tensor,
    or one rank, takes the process group (the emulated schedule); a CUDA
    tensor over two ranks with no world raises instead of taking the
    host-staged hops."""
    import types
    from repro_torch.core import collectives
    from repro_torch.parallel.axis import ModelAxis
    monkeypatch.setattr(collectives.emulate, "group_size",
                        lambda pg: 1 if pg is None else 2)
    pg = object()
    world = rdma.PeerWorld.loopback(2, 4096, "cpu")
    card = types.SimpleNamespace(device=torch.device("cuda", 0))
    cpu = torch.zeros(4)
    pick = collectives._fused_target
    assert pick(card, ModelAxis(pg, 1, 2, world), "AllReduce") is world
    assert pick(cpu, ModelAxis(pg, 1, 2), "AllReduce") is pg
    assert pick(card, None, "AllReduce") is None
    with pytest.raises(ValueError, match="peer world"):
        pick(card, ModelAxis(pg, 1, 2), "AllReduce")


def test_bound_bytes_ar():
    """Per rank: x read (4n), tp wire rows written and read in each
    phase, the output written (4n); the partial sum stays in registers:
    32 MB at qwen3-14b's prefill site at tp = 4, int8 g128 (132 wire
    bytes a group)."""
    cfg = CommConfig(bits=8, group=128)
    n = 4 * 128 * 5120
    assert cfg.wire_bytes(n) == 132 * n // 128 == 2703360
    assert rdma.bound_bytes_ar(cfg, 4, n) == (
        4 * n + 2 * 4 * cfg.wire_bytes(n // 4)) * 2 == 31784960
