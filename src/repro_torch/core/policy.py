"""Site-addressable policy engine: which wire config applies where.

Sites (as in the JAX package): ``tp`` (TP AllReduce of activations),
``a2a`` (MoE dispatch), ``grad``, ``qag``, ``qgrad_rs``, ``tp_bwd`` and
``bridge``. Each site holds a :class:`Schedule` that resolves
``(site, layer_index) -> CommConfig``. Schedules are declarative
(uniform / first-last-K / per-layer list / depth-interpolated widths) and
load from the JSON files in ``configs/policies/`` unchanged.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.comm_config import (FRAME_HEADER_BYTES, NO_COMPRESSION,
                                          CommConfig, default_comm_config)

SITES = ("tp", "a2a", "grad", "qag", "qgrad_rs", "tp_bwd", "bridge")
LAYER_SITES = ("tp", "a2a", "tp_bwd")

SCHEDULE_KINDS = ("uniform", "first_last", "per_layer", "depth_interp")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Declarative ``layer_index -> Optional[CommConfig]`` map.

    kinds:
      uniform       every layer gets ``base`` (None = site disabled)
      first_last    layers ``< k`` and ``>= n_layers - k`` get ``edge``,
                    the middle gets ``base``
      per_layer     explicit list; indices past the end clamp to the last
      depth_interp  bit width linearly interpolated from ``start_bits``
                    (layer 0) to ``end_bits`` (layer n-1), paper-default
                    group/spike per width, the rest from ``base``

    ``layer=None`` resolves the representative config (``base`` or the
    first list entry). Attribute access delegates to it, so a uniform
    schedule reads like the flat ``CommConfig`` (``policy.tp.bits``).
    """
    kind: str = "uniform"
    base: Optional[CommConfig] = None
    edge: Optional[CommConfig] = None
    k: int = 1
    configs: Tuple[Optional[CommConfig], ...] = ()
    start_bits: int = 8
    end_bits: int = 8

    def __post_init__(self):
        assert self.kind in SCHEDULE_KINDS, f"unknown schedule {self.kind}"
        if self.kind == "per_layer":
            assert self.configs, "per_layer schedule needs >= 1 config"
        if self.kind == "first_last":
            assert self.k >= 1 and self.edge is not None

    def resolve(self, layer: Optional[int] = None,
                n_layers: Optional[int] = None) -> Optional[CommConfig]:
        """The config bound at ``layer`` (of ``n_layers`` total)."""
        if layer is None:
            if self.kind == "per_layer":
                return self.configs[0]
            return self.base
        if self.kind == "uniform":
            return self.base
        if self.kind == "per_layer":
            return self.configs[min(layer, len(self.configs) - 1)]
        assert n_layers is not None and n_layers >= 1, \
            f"{self.kind} schedule needs n_layers (CommPolicy.bind)"
        if self.kind == "first_last":
            if layer < self.k or layer >= n_layers - self.k:
                return self.edge
            return self.base
        if self.base is None:                        # depth_interp
            return None
        if n_layers == 1:
            bits = self.start_bits
        else:
            frac = layer / (n_layers - 1)
            bits = round(self.start_bits
                         + (self.end_bits - self.start_bits) * frac)
        return self.base.with_bits(int(bits))

    def map(self, fn: Callable[[CommConfig], CommConfig]) -> "Schedule":
        """``fn`` applied to every embedded config (commutes with
        resolution)."""
        m = lambda c: None if c is None else fn(c)
        return dataclasses.replace(
            self, base=m(self.base), edge=m(self.edge),
            configs=tuple(m(c) for c in self.configs))

    def __getattr__(self, name: str):
        # reached only for names a Schedule lacks: CommConfig fields
        if name.startswith("_"):
            raise AttributeError(name)
        cfg = Schedule.resolve(self)
        if cfg is None:
            raise AttributeError(
                f"disabled schedule has no attribute {name!r}")
        return getattr(cfg, name)


def uniform(cfg: Optional[CommConfig]) -> Schedule:
    return Schedule(kind="uniform", base=cfg)


def first_last_k(edge: CommConfig, mid: Optional[CommConfig],
                 k: int = 1) -> Schedule:
    return Schedule(kind="first_last", base=mid, edge=edge, k=k)


def per_layer(configs: Sequence[Optional[CommConfig]]) -> Schedule:
    return Schedule(kind="per_layer", configs=tuple(configs))


def depth_interp(base: CommConfig, start_bits: int,
                 end_bits: int) -> Schedule:
    return Schedule(kind="depth_interp", base=base,
                    start_bits=start_bits, end_bits=end_bits)


def as_schedule(v: Union[Schedule, CommConfig, None]) -> Schedule:
    return v if isinstance(v, Schedule) else uniform(v)


@dataclasses.dataclass(frozen=True)
class CommPolicy:
    """Resolves ``(site, layer_index) -> CommConfig``; None = exact."""
    tp: Schedule = uniform(NO_COMPRESSION)
    a2a: Schedule = uniform(NO_COMPRESSION)
    grad: Schedule = uniform(NO_COMPRESSION)
    qag: Schedule = uniform(None)
    qgrad_rs: Schedule = uniform(None)
    tp_bwd: Schedule = uniform(None)
    bridge: Schedule = uniform(None)
    ep_slice: bool = False
    grad_ef: bool = False
    n_layers: Optional[int] = None

    def __post_init__(self):
        for site in SITES:
            v = getattr(self, site)
            if not isinstance(v, Schedule):
                object.__setattr__(self, site, as_schedule(v))

    def resolve(self, site: str, layer: Optional[int] = None,
                n_layers: Optional[int] = None) -> Optional[CommConfig]:
        """The config bound at ``(site, layer)``; ``n_layers`` defaults to
        the bound depth."""
        assert site in SITES, f"unknown site {site!r}"
        sched: Schedule = getattr(self, site)
        return sched.resolve(layer, n_layers if n_layers is not None
                             else self.n_layers)

    def bind(self, n_layers: int) -> "CommPolicy":
        """Policy with the model depth attached (idempotent)."""
        if self.n_layers == n_layers:
            return self
        return dataclasses.replace(self, n_layers=n_layers)

    def map_sites(self, fn: Callable[[CommConfig], CommConfig],
                  sites: Sequence[str] = SITES) -> "CommPolicy":
        return dataclasses.replace(
            self, **{s: getattr(self, s).map(fn) for s in sites})


BF16_POLICY = CommPolicy()


def with_backend(policy: CommPolicy, backend: str) -> CommPolicy:
    """Route every enabled site through one codec backend
    (``"ref" | "cuda" | "auto"``)."""
    return policy.map_sites(
        lambda c: c.with_backend(backend) if c.enabled else c)


def with_scheme(policy: CommPolicy, scheme: str) -> CommPolicy:
    """Route every enabled AllReduce/A2A site through one schedule (the
    launch CLI's ``--comm-scheme``)."""
    return policy.map_sites(
        lambda c: c.with_scheme(scheme) if c.enabled else c,
        sites=("tp", "grad", "tp_bwd", "a2a"))


def with_framed_bridge(policy: CommPolicy, bits: int,
                       scheme: str = "hier_pp",
                       backend: Optional[str] = None) -> CommPolicy:
    """Policy with a framed pod-bridge tier at its own bit width.

    Installs a ``bridge``-site config (paper-default group/spike for
    ``bits``) with the self-describing frame header on, leaving every
    other site untouched: the mixed-policy-pods switch behind the launch
    CLI's ``--framed-bridge BITS``. The backend follows the grad site's
    unless given (the bridge runs the same codec, framed).
    """
    if backend is None:
        grad_cfg = policy.resolve("grad")
        backend = grad_cfg.backend if grad_cfg is not None else "auto"
    cfg = default_comm_config(bits, scheme=scheme,
                              backend=backend).with_framed()
    return dataclasses.replace(policy, bridge=uniform(cfg))


def paper_policy(tp_bits: int = 8, a2a_bits: int = 4,
                 grad_bits: int = 8, backend: str = "auto") -> CommPolicy:
    """The paper's configuration: INT8 g128 TP AllReduce, INT4 g32 MoE
    dispatch, hierarchical INT8 gradient sync."""
    return CommPolicy(
        tp=default_comm_config(tp_bits, backend=backend),
        a2a=default_comm_config(a2a_bits, backend=backend),
        grad=default_comm_config(grad_bits, scheme="hierarchical",
                                 backend=backend),
        qag=None,
    )


def aggressive_policy(backend: str = "auto") -> CommPolicy:
    """Everything compressed as hard as accuracy allows: INT5 g128 TP with
    Eq.-1 scales (the 4+1 bit split), scale_int elsewhere."""
    return CommPolicy(
        tp=default_comm_config(5, scale_int=True, backend=backend),
        a2a=default_comm_config(4, scale_int=True, backend=backend),
        grad=CommConfig(bits=4, group=32, spike=True, scale_int=True,
                        scheme="hier_pp", backend=backend),
        qag=default_comm_config(4, scale_int=True, backend=backend),
        qgrad_rs=default_comm_config(8, backend=backend),
        tp_bwd=default_comm_config(8, backend=backend),
        ep_slice=True,
    )


def depth_policy(edge_bits: int = 8, mid_bits: int = 4, k: int = 1,
                 grad_bits: int = 2, backend: str = "auto") -> CommPolicy:
    """Depth-scheduled paper policy: the first and last ``k`` layers keep
    ``edge_bits`` TP, the middle drops to ``mid_bits``, and the gradient
    sync runs at ``grad_bits`` with error feedback."""
    return CommPolicy(
        tp=first_last_k(default_comm_config(edge_bits, backend=backend),
                        default_comm_config(mid_bits, backend=backend),
                        k=k),
        a2a=default_comm_config(4, backend=backend),
        grad=default_comm_config(grad_bits, backend=backend),
        grad_ef=True,
    )


# ---------------------------------------------------------------------------
# JSON (the files in configs/policies/)
# ---------------------------------------------------------------------------

def _cfg_from_dict(d: Optional[Dict]) -> Optional[CommConfig]:
    if d is None:
        return None
    known = {f.name for f in dataclasses.fields(CommConfig)}
    bad = set(d) - known
    assert not bad, f"unknown CommConfig fields {sorted(bad)}"
    return CommConfig(**d)


def _schedule_from_dict(d: Optional[Dict]) -> Schedule:
    if d is None:
        return uniform(None)
    kind = d.get("schedule", "uniform")
    if kind == "uniform":
        return uniform(_cfg_from_dict(d.get("config")))
    if kind == "first_last":
        return first_last_k(_cfg_from_dict(d["edge"]),
                            _cfg_from_dict(d.get("mid")),
                            k=int(d.get("k", 1)))
    if kind == "per_layer":
        return per_layer([_cfg_from_dict(c) for c in d["configs"]])
    if kind == "depth_interp":
        return depth_interp(_cfg_from_dict(d["base"]),
                            int(d["start_bits"]), int(d["end_bits"]))
    raise ValueError(f"unknown schedule kind {kind!r}")


def policy_from_json(text: str) -> CommPolicy:
    doc = json.loads(text)
    sites = doc.get("sites", {})
    bad = set(sites) - set(SITES)
    assert not bad, f"unknown policy sites {sorted(bad)}"
    kw = {s: _schedule_from_dict(sites.get(s))
          for s in SITES if s in sites}
    return CommPolicy(ep_slice=bool(doc.get("ep_slice", False)),
                      grad_ef=bool(doc.get("grad_ef", False)), **kw)


def load_policy_file(path: str) -> CommPolicy:
    with open(path) as f:
        return policy_from_json(f.read())


# ---------------------------------------------------------------------------
# describe_policy: the startup banner (per-site / per-layer wire plan)
# ---------------------------------------------------------------------------

def _cfg_cols(cfg: Optional[CommConfig], n: int) -> Tuple[str, ...]:
    if cfg is None or not cfg.enabled:
        return ("-", "-", "-", "exact", "-", f"{2 * n}", "1.00x")
    outlier = "SR" if cfg.spike else ("RH" if cfg.rotation else "-")
    return (str(cfg.bits), str(cfg.group), outlier,
            cfg.scheme, cfg.backend, str(cfg.wire_bytes(n)),
            f"{cfg.compression_ratio(n):.2f}x")


def _ranges(eq: List[bool]) -> List[Tuple[int, int]]:
    """Contiguous runs of equal entries -> [(start, end_inclusive)]."""
    runs, start = [], 0
    for i in range(1, len(eq)):
        if not eq[i]:
            runs.append((start, i - 1))
            start = i
    runs.append((start, len(eq) - 1))
    return runs


def describe_policy(policy: CommPolicy, n_layers: Optional[int] = None,
                    n: int = 4096) -> str:
    """Human-readable per-site / per-layer wire plan (bits, group, spike,
    scheme, backend, wire bytes and compression for ``n`` numbers)."""
    nl = n_layers if n_layers is not None else policy.n_layers
    head = ("site", "layers", "bits", "group", "spike", "scheme",
            "backend", f"wire B/{n}", "ratio")
    rows = [head]
    for site in SITES:
        if site in LAYER_SITES and nl:
            cfgs = [policy.resolve(site, i, nl) for i in range(nl)]
            eq = [True] + [cfgs[i] == cfgs[i - 1] for i in range(1, nl)]
            for s, e in _ranges(eq):
                span = str(s) if s == e else f"{s}-{e}"
                rows.append((site, span) + _cfg_cols(cfgs[s], n))
        else:
            rows.append((site, "*") + _cfg_cols(policy.resolve(site), n))
    widths = [max(len(r[i]) for r in rows) for i in range(len(head))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
             for r in rows]
    flags = []
    if policy.ep_slice:
        flags.append("ep_slice")
    if policy.grad_ef:
        flags.append("grad_ef (error-feedback gradient compression)")
    if flags:
        lines.append("flags: " + ", ".join(flags))
    framed = []
    for site in SITES:
        cfg = policy.resolve(site)
        if cfg is not None and cfg.enabled and cfg.framed:
            pct = 100.0 * FRAME_HEADER_BYTES / cfg.wire_bytes(n)
            framed.append(f"{site} +{FRAME_HEADER_BYTES} B/frame header "
                          f"({pct:.1f}% of wire @ n={n})")
    if framed:
        lines.append("framed: " + ", ".join(framed))
    return "\n".join(lines)
