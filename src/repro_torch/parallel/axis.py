"""A mesh axis as a rank process sees it.

A model runs its TP sites over a ``group`` argument: ``None`` (one rank),
a ``torch.distributed`` process group, or a :class:`ModelAxis`, which
adds the peer world that the fused collectives push through
(:mod:`repro_torch.launch.mesh` builds it). The same three serve the
data and pod axes of training (:class:`MeshAxes`). :func:`axis_parts`
reads any of the three; :mod:`repro_torch.core.collectives` hands the
kernel layer the process group or the peer world it picks from them.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple


class ModelAxis(NamedTuple):
    """The TP ranks of one model replica, seen from rank ``rank``.

    ``pg`` is their process group (the library collectives: the
    ``two_step`` hop, exact sites, greedy decoding's gather); ``world``
    the :class:`~repro_torch.kernels.rdma.PeerWorld` of the ``fused``
    sites, or ``None``.

    An MoE plan that factorises the axis ``tp = ep * etp`` with both
    above 1 runs its collectives on subaxes, each a ``ModelAxis`` of its
    own (its process group, this rank's index in it, size, peer world):
    ``ep``, this rank's group of ``MoEPlan.ep_groups`` (the dispatch and
    the combine; index ``ep_idx``), and ``etp``, its group of
    ``MoEPlan.etp_groups`` (the within-expert AllReduce; index
    ``tp_idx``). ``None`` otherwise.
    """
    pg: Any
    rank: int
    size: int
    world: Optional[Any] = None
    ep: Optional["ModelAxis"] = None
    etp: Optional["ModelAxis"] = None


def axis_parts(group) -> Tuple[Any, int, Optional[Any]]:
    """``group`` -> (process group or ``None``, this process's rank in it,
    peer world or ``None``)."""
    if group is None:
        return None, 0, None
    if isinstance(group, ModelAxis):
        return group.pg, group.rank, group.world
    import torch.distributed as dist
    return group, dist.get_rank(group), None


def axis_rank(group) -> int:
    """This process's rank in ``group``."""
    return axis_parts(group)[1]


class MeshAxes(NamedTuple):
    """One rank's axes of the training mesh ``DATA,MODEL[,POD]``: each a
    group as above (``None`` for an axis of one rank). ``multi_pod`` says
    whether the mesh has a pod axis at all (its size may be 1): the
    cross-pod gradient sync runs then, as in the JAX package."""
    model: Any = None
    data: Any = None
    pod: Any = None
    multi_pod: bool = False
