"""The hand kernels' budget on the card: the counterpart of the JAX
package's ``analysis/vmem.py``.

The JAX package budgets its Pallas kernels' VMEM on a TPU core. The
port's kernels are CUDA C++ for Hopper, so what can overflow is the
card's: threads a block, shared memory a block and a multiprocessor,
registers a thread and a multiprocessor, the residency of a cooperative
grid, and the device memory of the peer worlds. This module proves,
before a launch:

* **the instantiation table** (:data:`INSTANCES`): every kernel
  instantiation the five libraries compile, with what its wrapper
  launches (threads a block, dynamic shared bytes), its
  ``__launch_bounds__`` minimum of blocks a multiprocessor and, for
  ``fc_ar`` / ``fc_a2a``, its ``AR_MODES`` / ``A2A_MODES`` key, held
  against the card's limits (CARD-THREADS, CARD-SMEM);
* **the CUDA codec's launch contract** (CARD-CODEC), in place of the
  JAX package's ``_pick_block`` check: the group in ``KERNEL_GROUPS``,
  theta in [2, ``_MAX_THETA``], the payload unframed at the kernel (the
  codec wraps the frame), the decode's items within its 32-bit index;
* **a fused site** (SITE-FUSED-MESH with the rule that fired): the axis
  at most ``MAX_PEERS``, an instantiation of ``fc_ar`` / ``fc_a2a`` for
  the config, and the peer worlds of the ranks sharing a card within its
  memory (CARD-PEERMEM): :func:`~repro_torch.kernels.rdma.rank_layout`
  bytes a rank of every world the launcher builds, from the same
  :func:`~repro_torch.launch.mesh.site_row_bytes` it uses.

With the card itself present (:func:`read_attrs`, :func:`check_residency`)
two more: each built kernel's registers, local (spill) bytes and static
shared bytes, which the compiler decides, read from its library
(``fc_<source>_attrs``, which returns ``cudaFuncGetAttributes`` of each
instantiation) against the table and the limits (CARD-ATTRS, CARD-REGS,
CARD-SMEM); and the cooperative kernels'
residency for the ranks on one card (CARD-RESIDENT, the occupancy
queries behind ``rdma._blocks_per_rank``).

The limits are arguments (:class:`CardLimits`): :data:`H100` by default,
read from ``torch.cuda.get_device_properties`` on the card
(:func:`card_limits`), so the CPU tests can plant them.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

from repro_torch.analysis.report import Diagnostic, err, warn
from repro_torch.core.comm_config import CommConfig
from repro_torch.kernels.protocol import live_protocols
from repro_torch.kernels.crc import STAGES, TILE
from repro_torch.kernels.rdma import (A2A_MODES, A2A_THREADS, AR_MODES,
                                      MAX_PEERS, rank_layout)
from repro_torch.kernels.wire import _MAX_THETA, KERNEL_GROUPS


class CardLimits(NamedTuple):
    """What one card allows (``cards``: how many the host has)."""
    name: str
    threads_per_block: int
    smem_per_block: int           # bytes a block may opt in to
    smem_per_sm: int              # bytes a multiprocessor holds
    regs_per_sm: int
    regs_per_thread: int
    sms: int
    memory_bytes: int
    cards: int = 1


#: NVIDIA H100 SXM5 80 GB (compute capability 9.0): the CUDA C++
#: Programming Guide's table of technical specifications for 9.0 (1024
#: threads a block, 227 KB of shared memory a block, 228 KB a
#: multiprocessor, 64 K 32-bit registers a multiprocessor, 255 a thread)
#: and the H100's 132 multiprocessors and 80 GB of HBM3.
H100 = CardLimits(name="NVIDIA H100 80GB HBM3", threads_per_block=1024,
                  smem_per_block=227 * 1024, smem_per_sm=228 * 1024,
                  regs_per_sm=65536, regs_per_thread=255, sms=132,
                  memory_bytes=80 * 10 ** 9, cards=1)


def card_limits(device=None) -> CardLimits:
    """The limits of the card ``device`` (the current one by default),
    from ``torch.cuda.get_device_properties``; a property this PyTorch
    does not report keeps the H100's value."""
    import torch
    props = torch.cuda.get_device_properties(
        device if device is not None else torch.cuda.current_device())

    def get(name, default):
        v = getattr(props, name, None)
        return int(v) if v else default
    return CardLimits(
        name=props.name,
        threads_per_block=get("max_threads_per_block",
                              H100.threads_per_block),
        smem_per_block=get("shared_memory_per_block_optin",
                           H100.smem_per_block),
        smem_per_sm=get("shared_memory_per_multiprocessor",
                        H100.smem_per_sm),
        regs_per_sm=get("regs_per_multiprocessor", H100.regs_per_sm),
        regs_per_thread=H100.regs_per_thread,
        sms=props.multi_processor_count, memory_bytes=props.total_memory,
        cards=torch.cuda.device_count())


# ---------------------------------------------------------------------------
# the instantiation table
# ---------------------------------------------------------------------------

class Instance(NamedTuple):
    """One compiled kernel instantiation and how its wrapper launches it.

    ``threads`` is the largest block a launch uses; ``dynamic_smem`` the
    shared bytes the launch asks for; ``min_blocks`` the
    ``__launch_bounds__`` minimum of blocks a multiprocessor (0: none
    given); ``mode`` the ``AR_MODES`` / ``A2A_MODES`` key of an ``fc_ar``
    / ``fc_a2a`` instantiation (``()`` otherwise). Static shared bytes and
    registers are the compiler's: :func:`read_attrs` takes them from the
    built library."""
    source: str
    kernel: str
    threads: int
    dynamic_smem: int
    min_blocks: int
    mode: Tuple = ()


_BLOCK = 512                    # csrc/codec.cuh kBlockThreads
_ROWS_IN_FLIGHT = 4             # csrc/wire.cu kRowsInFlight
_CRC_THREADS = 256 + 32         # csrc/crc.cu kBlock: consumers + producer
_CRC_ROWS_THREADS = 128         # crc.cu crc_rows' block
#: csrc/crc.cu kSmem: the ring of STAGES tiles, the table (32 copies of
#: 256 words), the advance's 4 x 256 words, 32 parts, 2 x STAGES barriers
_CRC_SMEM = STAGES * TILE + 256 * 32 * 4 + 4 * 256 * 4 + 32 * 4 \
    + 2 * STAGES * 8
_AR_THREADS = 256               # csrc/allreduce.cu kThreads
_MODE_ARGS = {m: f"{m[0]}, {str(m[1]).lower()}, {str(m[2]).lower()}"
              for m in AR_MODES}


def _instances() -> Tuple[Instance, ...]:
    """Every instantiation, each source's in the order its
    ``fc_<source>_attrs`` reports them."""
    out: List[Instance] = []
    for m in AR_MODES:                              # wire.cu
        out.append(Instance("wire.cu", f"encode_kernel<{_MODE_ARGS[m]}>",
                            _BLOCK, 0, 0))
    for m in AR_MODES:
        for o in range(3):
            out.append(Instance(
                "wire.cu", f"decode_kernel<{_MODE_ARGS[m]}, {o}>",
                _BLOCK, 0, 0))
    for m in AR_MODES:
        for rf in (1, _ROWS_IN_FLIGHT):
            out.append(Instance(
                "wire.cu", f"decode_reduce_kernel<{_MODE_ARGS[m]}, {rf}>",
                _BLOCK, 0, 1 if rf == 1 else 2))
    for g in KERNEL_GROUPS:                         # stage.cu
        for spike in (False, True):
            for t in ("float", "__nv_bfloat16"):
                out.append(Instance(
                    "stage.cu",
                    f"pack_kernel<{g}, {str(spike).lower()}, {t}>",
                    _BLOCK, 0, 0))
    for g in KERNEL_GROUPS:
        out.append(Instance("stage.cu", f"unpack_kernel<{g}>", _BLOCK, 0,
                            0))
    for m in AR_MODES:                              # allreduce.cu
        out.append(Instance("allreduce.cu", f"ar_kernel<{_MODE_ARGS[m]}>",
                            _AR_THREADS, 0, 1 if m[2] else 3, m))
    for m in A2A_MODES:                             # rdma.cu
        t = ("float", "__nv_bfloat16")[m[4]]
        out.append(Instance("rdma.cu",
                            f"a2a_kernel<{_MODE_ARGS[m[1:4]]}, {t}>",
                            A2A_THREADS, 0, 3, m))
    for ring in (True, False):                      # crc.cu
        out.append(Instance("crc.cu", f"crc_tiles<{str(ring).lower()}>",
                            _CRC_THREADS, _CRC_SMEM, 1))
    out.append(Instance("crc.cu", "crc_rows", _CRC_ROWS_THREADS, 0, 0))
    return tuple(out)


#: every kernel instantiation of the five libraries
INSTANCES: Tuple[Instance, ...] = _instances()
SOURCES = ("wire.cu", "stage.cu", "allreduce.cu", "rdma.cu", "crc.cu")


def _check_smem(k: Instance, static_smem: int,
                limits: CardLimits) -> List[Diagnostic]:
    """CARD-SMEM of one instantiation's block: its dynamic shared bytes
    and ``static_smem`` (0 where the library is not read)."""
    sub = f"{k.source} {k.kernel}"
    smem = static_smem + k.dynamic_smem
    if smem > limits.smem_per_block:
        return [err("CARD-SMEM",
                    f"{smem} bytes of shared memory a block (the card "
                    f"allows {limits.smem_per_block})", sub)]
    if k.min_blocks and k.min_blocks * smem > limits.smem_per_sm:
        return [err("CARD-SMEM",
                    f"__launch_bounds__ asks for {k.min_blocks} blocks a "
                    f"multiprocessor of {smem} shared bytes each "
                    f"({limits.smem_per_sm} there)", sub)]
    return []


def check_instances(instances: Sequence[Instance],
                    limits: CardLimits = H100) -> List[Diagnostic]:
    """CARD-THREADS / CARD-SMEM of what the wrappers launch: threads and
    dynamic shared bytes a block."""
    out: List[Diagnostic] = []
    for k in instances:
        if k.threads > limits.threads_per_block:
            out.append(err("CARD-THREADS",
                           f"{k.threads} threads a block (the card allows "
                           f"{limits.threads_per_block})",
                           f"{k.source} {k.kernel}"))
        out += _check_smem(k, 0, limits)
    return out


def check_budget(limits: CardLimits = H100) -> Tuple[List[Diagnostic], int]:
    """The whole table against ``limits``; returns (diags, checked)."""
    return check_instances(INSTANCES, limits), len(INSTANCES)


# ---------------------------------------------------------------------------
# what the built libraries say (the card only)
# ---------------------------------------------------------------------------

class Attrs(NamedTuple):
    """``cudaFuncGetAttributes`` of one built instantiation."""
    max_threads: int
    regs: int
    static_smem: int
    local_bytes: int
    max_dynamic_smem: int


_ATTR_INTS = len(Attrs._fields)


def read_attrs(sources: Sequence[str] = SOURCES
               ) -> Dict[str, List[Attrs]]:
    """Each source's instantiations' attributes, in :data:`INSTANCES`'
    order, from its built library (built here if need be; the card
    only)."""
    from repro_torch.kernels import build
    out: Dict[str, List[Attrs]] = {}
    for source in sources:
        lib = build.load(source)
        fn = getattr(lib, f"fc_{source.split('.')[0]}_attrs")
        fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        fn.restype = ctypes.c_int
        cap = sum(1 for k in INSTANCES if k.source == source)
        buf = (ctypes.c_int * (_ATTR_INTS * (cap + 1)))()
        got = fn(buf, cap + 1)
        if got < 0:
            raise RuntimeError(f"fc_{source.split('.')[0]}_attrs failed: "
                               f"CUDA error {-got}")
        out[source] = [Attrs(*buf[_ATTR_INTS * i:_ATTR_INTS * (i + 1)])
                       for i in range(got)]
    return out


def check_attrs(attrs: Dict[str, List[Attrs]],
                limits: CardLimits = H100,
                instances: Sequence[Instance] = INSTANCES
                ) -> Tuple[List[Diagnostic], int]:
    """CARD-ATTRS / CARD-REGS / CARD-SMEM: each built instantiation
    against its table entry, and its registers and static plus dynamic
    shared bytes against the card; returns (diags, checked)."""
    out: List[Diagnostic] = []
    checked = 0
    for source in sorted({k.source for k in instances}):
        decl = [k for k in instances if k.source == source]
        got = attrs.get(source, [])
        if len(got) != len(decl):
            out.append(err("CARD-ATTRS",
                           f"the library reports {len(got)} "
                           f"instantiations, the table declares "
                           f"{len(decl)}", source))
        for k, a in zip(decl, got):
            checked += 1
            sub = f"{k.source} {k.kernel}"
            out += _check_smem(k, a.static_smem, limits)
            if a.max_threads < k.threads:
                out.append(err("CARD-REGS",
                               f"launches {k.threads} threads a block but "
                               f"its {a.regs} registers a thread allow "
                               f"{a.max_threads}", sub))
            elif a.max_threads != k.threads:
                out.append(err("CARD-ATTRS",
                               f"built for blocks of {a.max_threads} "
                               f"threads (__launch_bounds__), {k.threads} "
                               f"declared", sub))
            if a.regs > limits.regs_per_thread:
                out.append(err("CARD-REGS",
                               f"{a.regs} registers a thread (the card "
                               f"allows {limits.regs_per_thread})", sub))
            elif k.min_blocks and \
                    k.min_blocks * k.threads * a.regs > limits.regs_per_sm:
                out.append(err("CARD-REGS",
                               f"{k.min_blocks} blocks of {k.threads} "
                               f"threads at {a.regs} registers need more "
                               f"than a multiprocessor's "
                               f"{limits.regs_per_sm}", sub))
            if a.local_bytes:
                out.append(warn("CARD-REGS",
                                f"{a.local_bytes} bytes of local memory a "
                                f"thread (spilled registers or a stack "
                                f"array)", sub))
    return out, checked


def check_residency(keys: Sequence, local_ranks: int, dev: int = 0,
                    blocks_per_rank: Optional[Callable] = None,
                    subject: str = "") -> List[Diagnostic]:
    """CARD-RESIDENT: each ``AR_MODES`` / ``A2A_MODES`` key's cooperative
    grid keeps at least one block of each of ``local_ranks`` ranks
    resident on card ``dev`` (``blocks_per_rank(key, dev, local_ranks)``,
    by default the kernels' own occupancy query)."""
    if blocks_per_rank is None:
        from repro_torch.kernels.rdma import _blocks_per_rank
        blocks_per_rank = _blocks_per_rank
    out: List[Diagnostic] = []
    for key in keys:
        name = "fc_a2a" if key[0] == "a2a" else "fc_ar"
        try:
            bpr = blocks_per_rank(key, dev, local_ranks)
        except RuntimeError as e:
            bpr, why = 0, f" ({e})"
        else:
            why = ""
        if bpr < 1:
            out.append(err("CARD-RESIDENT",
                           f"{name} {key}: no block of each of "
                           f"{local_ranks} ranks stays resident{why}",
                           subject))
    return out


# ---------------------------------------------------------------------------
# the codec's launch contract and a fused site
# ---------------------------------------------------------------------------

def check_codec_launch(cfg: CommConfig, rows: int, n: int,
                       subject: str) -> List[Diagnostic]:
    """CARD-CODEC: the CUDA wire kernels' contract for one ``(rows, n)``
    launch of ``cfg`` (what ``kernels/wire.py`` ``_check_cfg`` and
    ``_params`` refuse, and ``fc_decode_wire``'s 32-bit item count)."""
    out: List[Diagnostic] = []
    if cfg.group not in KERNEL_GROUPS:
        out.append(err("CARD-CODEC",
                       f"group {cfg.group} is not one of the kernels' "
                       f"{KERNEL_GROUPS}", subject))
    if not 2 <= cfg.theta <= _MAX_THETA:
        out.append(err("CARD-CODEC",
                       f"theta {cfg.theta} outside [2, {_MAX_THETA}]",
                       subject))
    if cfg.framed:
        out.append(err("CARD-CODEC",
                       "a framed config at the kernel: the wire kernels "
                       "take the raw payload (the codec wraps the frame)",
                       subject))
    items = rows * (n // 8)
    if items > 0xFFFFFFFF - _BLOCK:
        out.append(err("CARD-CODEC",
                       f"({rows}, {n}) is {items} decode items, past the "
                       f"kernel's 32-bit index", subject))
    return out


def check_codec_static() -> Tuple[List[Diagnostic], int]:
    """The launch contract across the JAX package's representative codec
    shapes (its ``check_vmem_static`` sweep); returns (diags, checked)."""
    cfg = CommConfig()
    out: List[Diagnostic] = []
    checked = 0
    for rows in (1, 7, 8, 65, 1024, 16384):
        for n in (128, 4096, 16384, 65536):
            out += check_codec_launch(cfg, rows, n, f"rows={rows} n={n}")
            checked += 1
    return out, checked


def fused_mode(cfg: CommConfig, site: str, payload_kind: int = 1) -> Tuple:
    """The ``AR_MODES`` key of a fused AllReduce site's config, or the
    ``A2A_MODES`` key of a fused dispatch's (``payload_kind``: 0 float32,
    1 bfloat16)."""
    m = (cfg.group, bool(cfg.spike), bool(cfg.rotation))
    return ("a2a", *m, payload_kind) if site == "a2a" else m


def fused_instances(keys: Sequence) -> List[Instance]:
    """The table's instantiations of ``fc_ar`` / ``fc_a2a`` keys."""
    keys = set(keys)
    return [k for k in INSTANCES if k.mode and k.mode in keys]


def check_fused_site(cfg: CommConfig, site: str, axis: int,
                     payload_kind: int, subject: str) -> List[Diagnostic]:
    """A fused site's kernel at an axis of ``axis`` ranks: the axis at
    most MAX_PEERS, the config's codec contract, and an instantiation of
    ``fc_ar`` (``fc_a2a`` at the dispatch) for it."""
    out: List[Diagnostic] = []
    if axis > MAX_PEERS:
        out.append(err("SITE-FUSED-MESH",
                       f"axis of {axis} ranks: the peer-push kernels take "
                       f"at most MAX_PEERS = {MAX_PEERS}", subject))
    out += check_codec_launch(cfg.with_framed(False), 1, cfg.group, subject)
    key = fused_mode(cfg, site, payload_kind)
    modes = A2A_MODES if site == "a2a" else AR_MODES
    if key not in modes:
        name = "fc_a2a" if site == "a2a" else "fc_ar"
        out.append(err("SITE-FUSED-MESH",
                       f"{name} has no instantiation for {key}", subject))
    return out


def _launch_rows(global_batch: int, mesh_shape: Dict[str, int],
                 mode: str) -> int:
    """The batch rows a rank's peer worlds are sized for, as the
    launchers size them: a training step's ``batch // (pod * data)`` (or
    the whole batch), a served replica's ``batch // data`` (the whole
    batch when data does not divide it)."""
    data = mesh_shape.get("data", 1)
    if mode == "train":
        return global_batch // (mesh_shape.get("pod", 1) * data) \
            or global_batch
    return global_batch // data if global_batch % data == 0 \
        else global_batch


def peer_worlds(cfg, plan, mesh_shape: Dict[str, int], *,
                global_batch: int, seq: int, mode: str
                ) -> List[Tuple[str, int, int, int]]:
    """The peer worlds a rank of this launch builds on the card (the
    launchers' ``init_mesh``): (axis, ranks, receive-row bytes, bytes of
    the rank's region)."""
    from repro_torch.launch.mesh import GRAD_ROW_BYTES, site_row_bytes
    model, pod = mesh_shape.get("model", 1), mesh_shape.get("pod", 1)
    rows = site_row_bytes(cfg, plan,
                          _launch_rows(global_batch, mesh_shape, mode), seq)
    worlds = []
    if model > 1:
        worlds.append(("model", model, rows.model))
        if rows.ep:
            worlds += [("ep", plan.moe.ep, rows.ep),
                       ("etp", plan.moe.etp, rows.etp)]
    if mode == "train" and pod > 1:
        worlds.append(("pod", pod, GRAD_ROW_BYTES))
    return [(name, n, rb, rank_layout(live_protocols(n), rb)[1])
            for name, n, rb in worlds]


def check_peer_memory(worlds: Sequence[Tuple[str, int, int, int]],
                      world_size: int, limits: CardLimits = H100,
                      subject: str = "") -> List[Diagnostic]:
    """CARD-PEERMEM: the regions of every rank sharing a card (``world
    size`` ranks over ``limits.cards`` cards) within its memory."""
    per_rank = sum(w[3] for w in worlds)
    on_card = -(-world_size // max(1, limits.cards))
    total = per_rank * on_card
    if total <= limits.memory_bytes:
        return []
    parts = ", ".join(f"{name} world of {n}: {b} B a rank ({rb} B rows)"
                      for name, n, rb, b in worlds)
    return [err("CARD-PEERMEM",
                f"{on_card} ranks on a card need {total} bytes of peer "
                f"worlds ({parts}), the card has {limits.memory_bytes}",
                subject)]
