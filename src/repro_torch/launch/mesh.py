"""The mesh of one rank process, and the rank processes themselves.

The counterpart of the JAX package's ``launch/mesh.py``: where JAX builds
one mesh over every device in one process, the port runs one process a
rank. :func:`run_ranks` starts the rank processes (with ``subprocess``: a
process must not fork after CUDA is up) and fails when one of them
fails; each rank then calls :func:`init_mesh` for its
:class:`~repro_torch.parallel.axis.MeshAxes`, the mesh ``DATA,MODEL[,POD]``
seen from rank ``r`` at coordinate ``(pod, data, model)`` in JAX's
row-major order:

* one process group over a ``FileStore`` rendezvous (``nccl`` when every
  rank has a card of its own, ``gloo`` when ranks share one, as NCCL
  refuses two ranks on one card, or run on the CPU), and a subgroup for
  each axis of more than one rank (a :class:`~repro_torch.parallel.axis.
  ModelAxis`; an axis of one rank is ``None``);
* for an MoE plan with ep and etp both above 1, the model axis's ``ep``
  and ``etp`` subaxes: a subgroup for every group of the plan's
  ``ep_groups`` and ``etp_groups``;
* the rank on card ``rank % torch.cuda.device_count()``;
* on the card, for the model and the pod axes and the model axis's
  subaxes, the peer world of their ``fused`` collectives
  (:meth:`~repro_torch.kernels.rdma.PeerWorld.from_group`): each model
  world's receive rows sized from the largest site it serves, a TP site,
  an MoE dispatch or a within-expert AllReduce (:func:`site_row_bytes`),
  the pod axis's :data:`GRAD_ROW_BYTES` (a larger gradient leaf crosses
  in pieces).

Serving takes ``--mesh DATA,MODEL`` (:func:`parse_mesh`: ``DATA``
data-parallel replicas of ``MODEL`` TP ranks each, the weights' flat
store sharded over the data axis); training takes ``--mesh
DATA,MODEL[,POD]`` (:func:`parse_train_mesh`). The data axis has no peer
world: its gathers take the process group (host-staged over gloo when
the ranks share a card).
"""
from __future__ import annotations

import os
import subprocess
import tempfile
import time
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.models.moe import capacity
from repro_torch.parallel.axis import MeshAxes, ModelAxis

#: the largest quantization group the kernels take: the most a TP site's
#: vector, or a dispatch row, is padded
_MAX_GROUP = 128
#: receive-row bytes of a pod axis's peer world: a gradient leaf whose
#: wire chunk is larger crosses in pieces that fit
#: (:func:`repro_torch.core.collectives.quantized_all_reduce`)
GRAD_ROW_BYTES = 64 << 20
#: bytes a value of a row no wire of at most 8 bits exceeds (at most 1.375
#: bytes a value: int8 codes and a spiked group of 32's meta): the f32
#: payload's at a TP site, the bf16 payload's at a dispatch
_TP_VALUE_BYTES, _DISPATCH_VALUE_BYTES = 4, 2


def parse_mesh(text: str) -> Tuple[int, int]:
    """``"DATA,MODEL"`` -> (data, model), both positive."""
    dims = [int(v) for v in text.split(",")]
    if len(dims) != 2 or any(v < 1 for v in dims):
        raise ValueError(f"--mesh {text}: expected DATA,MODEL positive "
                         f"sizes")
    return dims[0], dims[1]


class WorldRows(NamedTuple):
    """Receive-row bytes of a model axis's peer worlds: ``model``, the
    axis's own; ``ep`` and ``etp``, its MoE subaxes' (0: the axis has no
    such subaxis)."""
    model: int
    ep: int = 0
    etp: int = 0


def _chunk_bytes(n: int, ranks: int, value_bytes: int) -> int:
    """Bytes of a rank's chunk of an ``n``-value vector padded to a
    ``ranks * 128`` multiple, ``value_bytes`` a value."""
    return value_bytes * (-(-n // (ranks * _MAX_GROUP)) * _MAX_GROUP)


def site_row_bytes(cfg, plan, batch: int, seq: int) -> WorldRows:
    """Receive-row bytes of each peer world that carries model ``cfg``'s
    sites on ``plan`` at ``batch`` x ``seq`` tokens a forward (a prefill
    served, ``batch`` the rows of one data replica, or a training step's
    ``b_loc`` x ``seq`` local tokens: the TP
    sites' backward, ``tp_bwd``, has their forward's shape, and the
    backwards of the dispatch and of the within-expert AllReduce are
    exact, over the process groups), each more than the wire of any
    config of at most 8 bits of what crosses it:

    * a TP site: ``batch * seq * d_model`` values padded to a
      ``tp * 128`` multiple, the f32 bytes of a rank's chunk; in an
      encoder-decoder model ``batch * max(seq, n_ctx)`` tokens, as its
      encoder's sites carry ``batch * n_ctx``;
    * the MoE dispatch (experts spread over ranks, ep > 1): the
      ``e_loc * capacity(batch * seq)`` rows of ``d_model`` values (a
      128 multiple) that a rank sends a peer, 2 bytes a value (a policy
      that slices the tokens by ep, ``ep_slice``, sends fewer);
    * the within-expert AllReduce (experts sharded, etp > 1): the
      ``e_loc * ep * capacity * d_model`` values of its partial sums
      padded to an ``etp * 128`` multiple, the f32 bytes of a rank's
      chunk.

    The model world carries the TP sites, and the dispatch where it
    spans the whole axis (etp = 1) or the AllReduce where that does
    (ep = 1). With ep and etp both above 1, the ``ep`` world carries the
    dispatch and the ``etp`` world the AllReduce.
    """
    t, d = batch * seq, cfg.d_model
    enc_t = batch * cfg.encoder.n_ctx if cfg.is_enc_dec else 0
    model = _chunk_bytes(max(t, enc_t) * d, plan.tp, _TP_VALUE_BYTES)
    mp = plan.moe
    if mp is None or plan.tp == 1:
        return WorldRows(model)
    cap = capacity(t, cfg)
    dispatch = (_DISPATCH_VALUE_BYTES * mp.e_loc * cap
                * (-(-d // _MAX_GROUP) * _MAX_GROUP))
    psum = _chunk_bytes(mp.e_loc * mp.ep * cap * d, mp.etp, _TP_VALUE_BYTES)
    if mp.etp == 1:
        return WorldRows(max(model, dispatch))
    if mp.ep == 1:
        return WorldRows(max(model, psum))
    return WorldRows(model, dispatch, psum)


def parse_train_mesh(text: str) -> Tuple[int, int, int]:
    """``"DATA,MODEL[,POD]"`` -> (data, model, pod); pod 0 means the mesh
    has no pod axis (no cross-pod gradient sync)."""
    dims = [int(v) for v in text.split(",")]
    if len(dims) not in (2, 3) or any(v < 1 for v in dims):
        raise ValueError(f"--mesh {text}: expected DATA,MODEL[,POD] "
                         f"positive sizes")
    return dims[0], dims[1], dims[2] if len(dims) == 3 else 0


def mesh_coord(rank: int, data: int, model: int) -> Tuple[int, int, int]:
    """Rank ``rank``'s (pod, data, model) coordinate, row-major."""
    return rank // (data * model), rank // model % data, rank % model


def _moe_subgroups(moe, lines: List[List[int]], rank: int):
    """Create the process group of every ``moe.ep_groups`` and
    ``moe.etp_groups`` group of every model axis (``lines``: each axis's
    global ranks in model order), every rank all of them in one order
    (``dist.new_group`` is collective over the world) -> [(this rank's
    ep group, its index there), (its etp group, its index there)], or
    ``None`` when the plan needs no subgroups."""
    if moe is None or moe.ep == 1 or moe.etp == 1:
        return None
    mine = [None, None]
    for line in lines:
        for kind, groups in enumerate((moe.ep_groups, moe.etp_groups)):
            for grp in groups:
                ranks = [line[m] for m in grp]
                pg = dist.new_group(ranks)
                if rank in ranks:
                    mine[kind] = (pg, ranks.index(rank))
    return mine


def init_mesh(data: int, model: int, pod: int, rank: int,
              rendezvous: Optional[str], device: torch.device,
              row_bytes: Union[int, WorldRows], moe=None) -> MeshAxes:
    """Rank ``rank`` of ``max(pod, 1) * data * model`` rank processes on
    ``device`` joins their process group at the ``FileStore`` file
    ``rendezvous`` (one process: nothing to join) and builds its axes
    (the module docstring; every rank creates every subgroup, in one
    order), the model axis's peer worlds with the receive rows of
    ``row_bytes`` (a :class:`WorldRows`, or the model world's bytes).
    With ``moe``, an :class:`~repro_torch.parallel.plan.MoEPlan` whose ep
    and etp are both above 1, the model axis gets its ``ep`` and ``etp``
    subaxes: a process group for every group of ``moe.ep_groups`` and
    ``moe.etp_groups`` on every model axis, this rank's index in each
    its position in the JAX package's group tuple (``ep_idx``,
    ``tp_idx``), and on the card a peer world each. Call
    :func:`close_mesh` on every rank when done."""
    rows = (row_bytes if isinstance(row_bytes, WorldRows)
            else WorldRows(row_bytes))
    world = max(pod, 1) * data * model
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    if world == 1:
        return MeshAxes(multi_pod=pod > 0)
    if not cuda and "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    own_cards = cuda and torch.cuda.device_count() >= world
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl" if own_cards else "gloo",
                            init_method=f"file://{rendezvous}", rank=rank,
                            world_size=world)
    sizes = (max(pod, 1), data, model)
    me = mesh_coord(rank, data, model)
    axes, lines = [], []
    for ax, size in enumerate(sizes):
        mine = None
        if size > 1:
            for other in range(world):        # every line along the axis
                c = mesh_coord(other, data, model)
                if c[ax] != 0:
                    continue
                ranks = [r for r in range(world)
                         if all(mesh_coord(r, data, model)[i] == c[i]
                                for i in range(3) if i != ax)]
                if ax == 2:
                    lines.append(ranks)
                pg = dist.new_group(ranks)
                if rank in ranks:
                    mine = (pg, ranks.index(rank))
        axes.append(mine)
    sub = _moe_subgroups(moe, lines, rank) if model > 1 else None

    def peer_world(pg, r, nbytes):
        if not cuda:
            return None
        from repro_torch.kernels.rdma import PeerWorld
        return PeerWorld.from_group(pg, r, nbytes, device)

    out = []
    for ax, part in enumerate(axes):
        if part is None:
            out.append(None)
            continue
        pg, r = part
        peer = None
        if ax != 1:                           # the model and pod axes
            peer = peer_world(pg, r, rows.model if ax == 2
                              else GRAD_ROW_BYTES)
        subaxes = {}
        if ax == 2 and sub is not None:
            (ep_pg, ep_r), (etp_pg, etp_r) = sub
            assert (ep_r, etp_r) == (r // moe.etp, r % moe.etp), (r, sub)
            subaxes = {
                "ep": ModelAxis(ep_pg, ep_r, moe.ep,
                                peer_world(ep_pg, ep_r, rows.ep)),
                "etp": ModelAxis(etp_pg, etp_r, moe.etp,
                                 peer_world(etp_pg, etp_r, rows.etp))}
        out.append(ModelAxis(pg, r, sizes[ax], peer, **subaxes))
    assert all(a is None or a.rank == me[i] for i, a in enumerate(out))
    return MeshAxes(model=out[2], data=out[1], pod=out[0],
                    multi_pod=pod > 0)


def barrier_all(mesh: MeshAxes) -> None:
    """A host barrier over every rank of the mesh (nothing for one)."""
    if any(a is not None for a in (mesh.model, mesh.data, mesh.pod)):
        dist.barrier()


def close_mesh(mesh: MeshAxes) -> None:
    """Wait for the card and every rank, close the peer worlds (the axes'
    and the model axis's subaxes'), leave the process group (nothing for
    one process)."""
    axes = [a for a in (mesh.model, mesh.data, mesh.pod) if a is not None]
    if not axes:
        return
    axes += [s for a in axes for s in (a.ep, a.etp) if s is not None]
    worlds = [a.world for a in axes if a.world is not None]
    if worlds:
        torch.cuda.synchronize(worlds[0].device)
    dist.barrier()
    for w in worlds:
        w.close()
    dist.destroy_process_group()


def rank_device(rank: int, device: torch.device) -> torch.device:
    """Rank ``rank``'s device: the CPU, or card ``rank % device_count``."""
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def barrier(axis: Optional[ModelAxis]) -> None:
    """A host barrier over the ranks (nothing for one rank), so that no
    rank's kernel waits on a peer that is still busy on the host."""
    if axis is not None:
        dist.barrier(group=axis.pg)


def run_ranks(cmd_of: Callable[[int, str], List[str]], world: int,
              timeout: Optional[float] = None) -> None:
    """Run ``world`` rank processes, ``cmd_of(rank, rendezvous)`` each
    (every rank of the mesh: ``data * model`` to serve),
    that meet at a ``FileStore`` file in a temporary directory. They
    inherit this process's output. When one fails (or ``timeout`` seconds
    pass), the others are killed and RuntimeError is raised."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory(prefix="fc_mesh_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(cmd_of(r, store), env=env)
                 for r in range(world)]
        t0 = time.monotonic()
        try:
            while True:
                codes = [p.poll() for p in procs]
                if all(c == 0 for c in codes) or any(c for c in codes):
                    break
                if timeout is not None and time.monotonic() - t0 > timeout:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(f"rank processes exited with codes {codes}")
