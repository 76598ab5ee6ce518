"""The model axis of one rank process, and the rank processes themselves.

The counterpart of the JAX package's ``launch/mesh.py``: where JAX builds
one mesh over every device in one process, the port serves ``--mesh
1,TP`` with one process a rank. :func:`run_ranks` starts the rank
processes (with ``subprocess``: a process must not fork after CUDA is
up) and fails when one of them fails; each rank then calls
:func:`init_model_axis` for its :class:`~repro_torch.parallel.axis.
ModelAxis`:

* the process group, over a ``FileStore`` rendezvous: ``nccl`` when every
  rank has a card of its own, ``gloo`` when ranks share one (NCCL refuses
  two ranks on one card) or run on the CPU;
* the rank, on card ``rank % torch.cuda.device_count()``;
* on the card and with more than one rank, the peer world of the fused
  collectives (:meth:`~repro_torch.kernels.rdma.PeerWorld.from_group`),
  its receive rows sized from the largest site it serves, a TP site or
  an MoE dispatch (:func:`site_row_bytes`).

Data parallelism (``DATA > 1``) is not ported.
"""
from __future__ import annotations

import os
import subprocess
import tempfile
import time
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.moe import capacity
from repro_torch.parallel.axis import ModelAxis

#: the largest quantization group the kernels take: the most a TP site's
#: vector, or a dispatch row, is padded
_MAX_GROUP = 128
#: bytes a value of a row no wire of at most 8 bits exceeds (at most 1.375
#: bytes a value: int8 codes and a spiked group of 32's meta): the f32
#: payload's at a TP site, the bf16 payload's at a dispatch
_TP_VALUE_BYTES, _DISPATCH_VALUE_BYTES = 4, 2


def parse_mesh(text: str) -> Tuple[int, int]:
    """``"DATA,MODEL"`` -> (data, model); only ``data == 1`` is served."""
    data, model = (int(v) for v in text.split(","))
    if data < 1 or model < 1:
        raise ValueError(f"--mesh {text}: sizes must be positive")
    if data != 1:
        raise NotImplementedError(f"--mesh {text}: data-parallel serving "
                                  f"(data > 1) is not ported")
    return data, model


def site_row_bytes(cfg, plan, batch: int, seq: int) -> int:
    """Receive-row bytes for every site that a peer world serving model
    ``cfg`` on ``plan`` at ``batch`` x ``seq`` tokens carries, the larger
    of two, each more than the wire of any config of at most 8 bits:

    * the largest TP site: ``batch * seq * d_model`` values padded to a
      ``tp * 128`` multiple, the f32 bytes of a rank's chunk;
    * with experts spread over ranks (ep > 1), the MoE dispatch: the
      ``e_loc * capacity(batch * seq)`` rows of ``d_model`` values (a
      128 multiple) that a rank sends a peer, 2 bytes a value. A policy
      that slices the tokens by ep (``ep_slice``) sends fewer.
    """
    tp, n = plan.tp, batch * seq * cfg.d_model
    rows = _TP_VALUE_BYTES * (-(-n // (tp * _MAX_GROUP)) * _MAX_GROUP)
    if plan.moe is not None and plan.moe.ep > 1:
        d = -(-cfg.d_model // _MAX_GROUP) * _MAX_GROUP
        m = plan.moe.e_loc * capacity(batch * seq, cfg)
        rows = max(rows, _DISPATCH_VALUE_BYTES * m * d)
    return rows


def rank_device(rank: int, device: torch.device) -> torch.device:
    """Rank ``rank``'s device: the CPU, or card ``rank % device_count``."""
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_model_axis(model: int, rank: int, rendezvous: str,
                    device: torch.device, row_bytes: int) -> ModelAxis:
    """Join the ``model`` ranks' process group at the ``FileStore`` file
    ``rendezvous`` as ``rank`` on ``device`` (see the module docstring);
    on the card, with ``model > 1``, build the peer world, its receive
    rows of ``row_bytes`` (:func:`site_row_bytes`)."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    elif "OMP_NUM_THREADS" not in os.environ:
        # the host's cores, shared out among the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // model))
    own_cards = cuda and torch.cuda.device_count() >= model
    # the ranks of one host meet over its loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl" if own_cards else "gloo",
                            init_method=f"file://{rendezvous}", rank=rank,
                            world_size=model)
    pg = dist.group.WORLD
    world = None
    if cuda and model > 1:
        from repro_torch.kernels.rdma import PeerWorld
        world = PeerWorld.from_group(pg, rank, row_bytes, device)
    return ModelAxis(pg, rank, model, world)


def barrier(axis: Optional[ModelAxis]) -> None:
    """A host barrier over the ranks (nothing for one rank), so that no
    rank's kernel waits on a peer that is still busy on the host."""
    if axis is not None:
        dist.barrier(group=axis.pg)


def close_model_axis(axis: ModelAxis) -> None:
    """Wait for this rank's card and for every rank, close the peer world,
    leave the process group."""
    if axis.world is not None:
        torch.cuda.synchronize(axis.world.device)
        barrier(axis)
        axis.world.close()
    dist.destroy_process_group()


def run_ranks(cmd_of: Callable[[int, str], List[str]], model: int,
              timeout: Optional[float] = None) -> None:
    """Run ``model`` rank processes, ``cmd_of(rank, rendezvous)`` each,
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
                 for r in range(model)]
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
