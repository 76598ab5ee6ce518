"""Comm-site lint: every site the model addresses, policy-resolved.

The port's copy of the JAX package's ``analysis/sites.py``. The model
code never touches a ``CommConfig`` directly: every communication site
routes through ``CommPolicy.resolve(site, layer)``. This checker proves
the contract per (model config, policy) pair, twice over:

**statically** (:func:`check_policy_sites`): enumerate the (site, layer)
pairs the architecture addresses (the per-block ``tp`` / ``tp_bwd``
AllReduces, every layer kind funnelling through ``layers.tp_psum``; the
MoE dispatch ``a2a`` at each moe block; the layer-``None`` embedding
AllReduce; the per-step ``grad`` / ``qag`` / ``qgrad_rs`` / ``bridge``
sites) and verify:

* **SITE-RESOLVE**: resolution succeeds at every addressed pair (a
  depth-interpolated schedule can hit an unsupported bit width mid
  stack) and the resolved config survives a round-trip through the plain
  codec whose wire buffer matches its own ``wire_layout`` accounting;
* **SITE-SCHEME**: the resolved scheme is implementable at that site's
  collective shape (the A2A dispatch is a single hop, so hierarchical
  schemes have no (inner, outer) split there; the gather/scatter sites
  have no fused kernel);
* **SITE-EF**: ``grad_ef`` only with an enabled grad, bridge or qgrad_rs
  site (otherwise the EF residuals are dead state);
* **SITE-QGRAD-ALIGN** (:func:`check_qgrad_alignment`): per-parameter
  group alignment of the qgrad reduce-scatter shards;
* **SITE-SEGMENT**: ``model.policy_segments`` must partition the
  repeats, and a depth-uniform policy must yield exactly one segment
  (the JAX package's scan invariant; the port's forward has no scan, but
  gives the same verdicts).

**dynamically** (:func:`trace_train_sites`): run one smoke-size train
step of the port (2 layers, seq 16, batch 2, one rank) under a recording
policy that logs every ``resolve`` call, where the JAX package lowers its
step, and verify the log hits the sites the static enumeration promises
(tp / tp_bwd / qag / qgrad_rs / grad / bridge always, a2a iff the stack
has moe blocks) with every logged layer index in range (SITE-TRACE). A
comm call that bypasses the engine never logs, so new model code cannot
silently grow unmanaged traffic.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Set, Tuple

import numpy as np

from repro_torch.analysis.report import Diagnostic, err, warn
from repro_torch.core.comm_config import SCHEMES, CommConfig
from repro_torch.core.policy import LAYER_SITES, SITES, CommPolicy

SiteAddr = Tuple[str, Optional[int]]

#: which collective schedules are implementable per site. tp/grad/tp_bwd
#: are AllReduce-shaped (every scheme runs, incl. the single-axis
#: degeneracies in collectives._flat_all_reduce); the MoE dispatch is a
#: single hop (no (inner, outer) split to be hierarchical over); the
#: ZeRO gather/scatter sites are codec-wrapped library collectives with
#: no fused kernel or hierarchy.
ALLOWED_SCHEMES = {
    "tp": set(SCHEMES),
    "grad": set(SCHEMES),
    "tp_bwd": set(SCHEMES),
    "a2a": {"nccl", "two_step", "fused"},
    "qag": {"nccl", "two_step"},
    "qgrad_rs": {"nccl", "two_step"},
    # the pod-bridge override is AllReduce-shaped like grad, but it is
    # meant to run framed and the fused kernels address raw wire offsets
    # (CommConfig forbids framed+fused too).
    "bridge": {"nccl", "two_step", "hierarchical", "hier_pp"},
}


def enumerate_sites(cfg) -> List[SiteAddr]:
    """Every (site, layer) pair the architecture addresses.

    ``cfg`` is a ``ModelConfig``; layer sites come from its
    ``layer_kinds``, the per-step sites resolve at ``layer=None`` (as
    does the embedding psum, which runs outside any block).
    """
    sites: List[SiteAddr] = [("tp", None)]          # embedding psum
    for i, kind in enumerate(cfg.layer_kinds):
        sites.append(("tp", i))
        sites.append(("tp_bwd", i))
        if kind == "moe":
            sites.append(("a2a", i))
    sites += [("grad", None), ("qag", None), ("qgrad_rs", None),
              ("bridge", None)]
    return sites


#: configs already round-tripped this process (an --all sweep resolves
#: the same handful of configs hundreds of times).
_ROUNDTRIP_OK: Set[CommConfig] = set()


def _roundtrip(cc: CommConfig, subject: str) -> List[Diagnostic]:
    """Plain-codec encode/decode agreement for one resolved config (the
    JAX package's runs its ``"ref"`` codec)."""
    import torch
    from repro_torch.core import codec
    if cc in _ROUNDTRIP_OK:
        return []
    n = 2 * cc.group
    rng = np.random.RandomState(0)
    x = np.asarray(rng.standard_normal((2, n)), np.float32)
    try:
        ref = cc.with_backend("ref")     # static check: no kernel paths
        wire = codec.encode(torch.from_numpy(x), ref)
        if tuple(wire.shape) != (2, cc.wire_bytes(n)):
            return [err("SITE-RESOLVE",
                        f"encode produced {tuple(wire.shape)}, wire_layout "
                        f"promises (2, {cc.wire_bytes(n)})", subject)]
        out = codec.decode(wire, ref, n, out_dtype=torch.float32).numpy()
    except Exception as e:                    # noqa: BLE001 — lint surface
        return [err("SITE-RESOLVE",
                    f"codec round-trip raised {type(e).__name__}: {e}",
                    subject)]
    if out.shape != x.shape or not np.all(np.isfinite(out)):
        return [err("SITE-RESOLVE",
                    "codec round-trip lost shape or produced non-finite "
                    "values", subject)]
    _ROUNDTRIP_OK.add(cc)
    return []


def check_policy_sites(cfg, policy: CommPolicy,
                       subject: str = "") -> List[Diagnostic]:
    """The static lint for one (model config, policy) pair."""
    from repro_torch.models.model import policy_segments
    out: List[Diagnostic] = []
    policy = policy.bind(cfg.n_layers)
    prefix = (subject + " ") if subject else ""
    seen: Set[CommConfig] = set()
    for site, layer in enumerate_sites(cfg):
        sub = f"{prefix}site={site} layer={layer}"
        try:
            cc = policy.resolve(site, layer)
        except Exception as e:                # noqa: BLE001 — lint surface
            out.append(err("SITE-RESOLVE",
                           f"resolve raised {type(e).__name__}: {e}", sub))
            continue
        if cc is None or not cc.enabled:
            continue
        if cc.scheme not in ALLOWED_SCHEMES[site]:
            out.append(err("SITE-SCHEME",
                           f"scheme {cc.scheme!r} is not implementable "
                           f"at site {site!r} (allowed: "
                           f"{sorted(ALLOWED_SCHEMES[site])})", sub))
        if cc not in seen:
            seen.add(cc)
            out += _roundtrip(cc, sub)
    # EF residual demands a live compressed site to correct: the
    # cross-pod grad AR (grad, or its bridge override) or the sharded-DP
    # qgrad_rs reduce-scatter.
    if policy.grad_ef:
        def dead(cc):
            return cc is None or not cc.enabled or cc.scheme == "nccl"
        if dead(policy.resolve("grad")) and \
                dead(policy.resolve("qgrad_rs")) and \
                dead(policy.resolve("bridge")):
            out.append(err("SITE-EF",
                           "grad_ef is set but the grad, bridge and "
                           "qgrad_rs sites all resolve exact/disabled — "
                           "the EF residuals would never be consumed",
                           prefix + "site=grad"))
    # scan segmentation invariant
    try:
        segs = policy_segments(cfg, policy)
    except Exception as e:                    # noqa: BLE001 — lint surface
        out.append(err("SITE-SEGMENT",
                       f"policy_segments raised {type(e).__name__}: {e}",
                       prefix.strip()))
        return out
    flat = [r for s, e in segs for r in range(s, e)]
    if flat != list(range(cfg.pattern_repeats)):
        out.append(err("SITE-SEGMENT",
                       f"segments {segs} do not partition the "
                       f"{cfg.pattern_repeats} pattern repeats",
                       prefix.strip()))
    uniform = all(getattr(policy, s).kind == "uniform"
                  for s in LAYER_SITES)
    if uniform and len(segs) != 1:
        out.append(err("SITE-SEGMENT",
                       f"uniform policy produced {len(segs)} scan "
                       f"segments (must be exactly 1 — the HLO-size "
                       f"invariant)", prefix.strip()))
    return out


def check_qgrad_alignment(cfg, plan, policy: CommPolicy,
                          subject: str = "") -> List[Diagnostic]:
    """Alignment lint for the qgrad_rs reduce-scatter, per parameter.

    The quantized gradient RS chunks each full-flat-length gradient into
    ``fsdp`` shards and group-pads the shards. The old in-VJP version
    silently fell back to an *exact* psum_scatter whenever
    ``flat % (fsdp * group) != 0`` — the declared policy just never
    applied. Now misalignment merely costs pad bytes, but it is still
    worth surfacing: a warning per misaligned parameter (error if the
    flat length cannot be sharded at all, which the store-layout padding
    should make impossible).
    """
    from repro_torch.models.model import param_groups
    out: List[Diagnostic] = []
    qc = policy.bind(cfg.n_layers).resolve("qgrad_rs")
    if qc is None or not qc.enabled or qc.scheme == "nccl" \
            or plan.fsdp <= 1:
        return out
    prefix = (subject + " ") if subject else ""
    for gname, (_, specs) in sorted(param_groups(cfg, plan).items()):
        for name, spec in sorted(specs.items()):
            flat = spec.flat_len(plan)
            sub = f"{prefix}site=qgrad_rs param={gname}/{name}"
            if flat % plan.fsdp != 0:
                out.append(err(
                    "SITE-QGRAD-ALIGN",
                    f"flat length {flat} is not divisible by "
                    f"fsdp={plan.fsdp} — the gradient cannot be "
                    f"reduce-scattered", sub))
            elif (flat // plan.fsdp) % qc.group != 0:
                out.append(warn(
                    "SITE-QGRAD-ALIGN",
                    f"per-rank shard {flat // plan.fsdp} is not a "
                    f"multiple of group={qc.group} — chunks are padded "
                    f"on the wire (the old silent exact fallback hid "
                    f"this site)", sub))
    return out


# ---------------------------------------------------------------------------
# the trace lane: run a real train step under a recording policy
# ---------------------------------------------------------------------------

def make_recording_policy(policy: CommPolicy, log: Set[SiteAddr]
                          ) -> CommPolicy:
    """A policy whose ``resolve`` logs every (site, layer) it is asked
    for, then delegates. Built as a dynamic subclass so
    ``dataclasses.replace`` (inside ``bind`` / ``map_sites``) keeps
    returning recording instances sharing the same log."""

    def resolve(self, site, layer=None, n_layers=None):
        log.add((site, layer if isinstance(layer, int) else None))
        return CommPolicy.resolve(self, site, layer, n_layers)

    cls = type("RecordingPolicy", (CommPolicy,), {"resolve": resolve})
    fields = {f.name: getattr(policy, f.name)
              for f in dataclasses.fields(CommPolicy)}
    return cls(**fields)


def record_train_sites(arch: str, policy: CommPolicy,
                       device: Optional[str] = None) -> Set[SiteAddr]:
    """The resolve log of one smoke-size train step of ``arch`` (seq 16,
    batch 2, one rank) under ``policy``, on the card unless ``device``
    is ``"cpu"``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import resolve_device
    from repro_torch.launch.train import train
    from repro_torch.parallel.axis import MeshAxes
    from repro_torch.parallel.plan import make_plan
    from repro_torch.train.optim import OptimConfig

    cfg = get_smoke_config(arch)
    log: Set[SiteAddr] = set()
    rec = make_recording_policy(policy, log)
    plan = make_plan(cfg, tp=1, fsdp=1)
    opt_cfg = OptimConfig(lr=1e-3, warmup_steps=2, total_steps=4)
    train(cfg, plan, rec, opt_cfg, MeshAxes(), batch=2, seq=16, steps=1,
          device=resolve_device(device), log=lambda *a, **k: None)
    return log


def trace_train_sites(arch: str, policy: CommPolicy, subject: str = "",
                      device: Optional[str] = None) -> List[Diagnostic]:
    """Run one smoke-size train step and check the resolve log.

    One step at 2 layers, seq 16, batch 2, on the card unless ``device``
    is ``"cpu"``: seconds on the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import resolve_device
    cfg = get_smoke_config(arch)
    sub = subject or f"trace {arch}"
    resolve_device(device)          # no card: raises here, not as a finding
    try:
        log = record_train_sites(arch, policy, device)
    except Exception as e:                    # noqa: BLE001 — lint surface
        return [err("SITE-TRACE",
                    f"train-step trace raised {type(e).__name__}: {e}",
                    sub)]
    return check_trace_log(cfg, log, sub)


def check_trace_log(cfg, log: Set[SiteAddr],
                    subject: str) -> List[Diagnostic]:
    """SITE-TRACE of one recorded resolve log of model ``cfg``."""
    out: List[Diagnostic] = []
    sub = subject
    logged_sites = {s for s, _ in log}
    # a2a is only addressed by moe blocks; everything else must appear
    expect = {s for s in SITES if s != "a2a"}
    if any(k == "moe" for k in cfg.layer_kinds):
        expect.add("a2a")
    missing = expect - logged_sites
    if missing:
        out.append(err("SITE-TRACE",
                       f"sites {sorted(missing)} were never resolved "
                       f"during the train-step trace — comm there "
                       f"bypasses the policy engine", sub))
    unknown = logged_sites - set(SITES)
    if unknown:
        out.append(err("SITE-TRACE",
                       f"trace resolved unknown sites {sorted(unknown)}",
                       sub))
    bad_layers = {(s, lyr) for s, lyr in log
                  if lyr is not None and not 0 <= lyr < cfg.n_layers}
    if bad_layers:
        out.append(err("SITE-TRACE",
                       f"trace resolved out-of-range layer indices "
                       f"{sorted(bad_layers)} (n_layers={cfg.n_layers})",
                       sub))
    layer_logged = {s for s, lyr in log if lyr is not None}
    need_layered = {"tp", "tp_bwd"} | ({"a2a"} if "a2a" in expect
                                       else set())
    if not need_layered <= layer_logged:
        out.append(err("SITE-TRACE",
                       f"layer sites {sorted(need_layered - layer_logged)} "
                       f"were never resolved at a concrete layer", sub))
    return out
