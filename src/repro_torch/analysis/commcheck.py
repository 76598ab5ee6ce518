"""commcheck: the static comm-safety analyzer CLI.

The port's copy of the JAX package's ``analysis/commcheck.py``. Usage
(PYTHONPATH=src):

  python -m repro_torch.analysis.commcheck              # core static pass
  python -m repro_torch.analysis.commcheck --all        # + every shipped
                                                        #   config x policy
                                                        #   x mesh pair
  python -m repro_torch.analysis.commcheck --selftest   # mutation fixtures
  python -m repro_torch.analysis.commcheck --trace      # + train-step
                                                        #   trace lane
  python -m repro_torch.analysis.commcheck --rules      # print rule table
  python -m repro_torch.analysis.commcheck --arch qwen3-14b --policy depth \\
      --mesh 2,4                                        # one launch pair
  python -m repro_torch.analysis.commcheck --all --card # the card's budget

The core static pass is shape-independent: peer-push choreography for
every model-axis size the launch meshes produce, the wire-layout
partition sweep, the CUDA codec's launch contract, and the frames.
``--all`` adds the comm-site lint for every architecture x stock policy x
JSON policy artifact, plus launch feasibility for every
``configs.all_pairs()`` lowering on the production meshes.

``--card`` (the JAX package's ``--tpu``) checks as if the launch ran the
hand kernels on the card: the kernel instantiation table against the
card's limits, the codec's launch contract and the fused sites' peer
worlds at each launch's exact shapes (:mod:`repro_torch.analysis.smem`);
run on a machine with the card it reads the limits from it, and the
built libraries' attributes and the cooperative kernels' residency too.
Launchers call :func:`launch_report` (``--check``) /
:func:`check_fused_request` (always) with their exact shapes before any
rank process starts.

Exit status is 0 iff no rule fired at error severity.
"""
from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import choreography, frames, layout, sites, smem
from repro_torch.analysis.report import (RULES, CheckReport, CommCheckError,
                                   err)
from repro_torch.core.comm_config import CommConfig
from repro_torch.core.policy import CommPolicy

#: model-axis sizes the launch meshes produce (--mesh data,model[,pod]
#: on train/serve accepts any size — these cover the shipped defaults,
#: the production tp=16, and odd/non-power-of-two shapes).
TP_VALUES = (2, 3, 4, 8, 16)

#: mesh shapes the launch CLIs accept, axis-name -> size.
MESH_SHAPES: Tuple[Dict[str, int], ...] = (
    {"data": 1, "model": 1},                      # CPU smoke default
    {"data": 2, "model": 4},                      # 8-device test mesh
    {"data": 16, "model": 16},                    # production single pod
    {"pod": 2, "data": 16, "model": 16},          # production multi pod
)


def _policy_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "configs" / "policies"


def shipped_policies() -> Dict[str, CommPolicy]:
    """Stock policies + every JSON artifact under configs/policies/."""
    from repro_torch.core.policy import (BF16_POLICY, aggressive_policy,
                                         depth_policy, load_policy_file,
                                         optimized_policy, paper_policy)
    pols: Dict[str, CommPolicy] = {
        "paper": paper_policy(), "bf16": BF16_POLICY,
        "optimized": optimized_policy(),
        "aggressive": aggressive_policy(), "depth": depth_policy(),
    }
    pdir = _policy_dir()
    if pdir.is_dir():
        for f in sorted(pdir.glob("*.json")):
            pols[f.name] = load_policy_file(str(f))
    return pols


# ---------------------------------------------------------------------------
# launch-time feasibility (exact shapes; called by the launch CLIs too)
# ---------------------------------------------------------------------------

def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _padded_payload(cc: CommConfig, n: int, axis_size: int) -> int:
    """The flat length the JAX package's ``compressed_psum`` communicates:
    padded to an (axis, group, pipeline-chunk) multiple."""
    chunks = cc.pipeline_chunks if cc.scheme == "hier_pp" else 1
    mult = max(1, axis_size) * cc.group * max(1, chunks)
    return _ceil_to(max(n, 1), mult)


def _site_payloads(cfg, plan, policy: CommPolicy,
                   mesh_shape: Dict[str, int], *, global_batch: int,
                   seq: int, n_micro: int, mode: str
                   ) -> List[Tuple[str, Optional[int], CommConfig, int, int]]:
    """(site, layer, config, flat_payload, axis_size) for every enabled
    site the launch would drive, with the JAX package's padded byte
    accounting of ``compressed_psum`` / the dispatch A2A (so both
    packages give one verdict on one launch)."""
    tp = mesh_shape.get("model", 1)
    pod = mesh_shape.get("pod", 1)
    dp = mesh_shape.get("data", 1) * pod
    b_loc = max(1, -(-global_batch // dp))
    mb = max(1, -(-b_loc // n_micro)) if mode == "train" else b_loc
    s = 1 if mode == "decode" else seq
    out = []
    seen = set()
    # a size-1 axis performs no communication: the psum/dispatch is an
    # identity and the wire codec never runs — nothing to budget.
    if tp > 1:
        for layer in range(cfg.n_layers):
            cc = policy.resolve("tp", layer)
            if cc is not None and cc.enabled and ("tp", cc) not in seen:
                seen.add(("tp", cc))
                n = _padded_payload(cc, mb * s * cfg.d_model, tp)
                out.append(("tp", layer, cc, n, tp))
    if cfg.moe is not None and plan.moe is not None and plan.moe.ep > 1:
        for layer, kind in enumerate(cfg.layer_kinds):
            if kind != "moe":
                continue
            cc = policy.resolve("a2a", layer)
            if cc is None or not cc.enabled or ("a2a", cc) in seen:
                continue
            seen.add(("a2a", cc))
            from repro_torch.models.moe import capacity
            t = mb * s
            if policy.ep_slice and plan.moe.ep > 1:
                t = -(-t // plan.moe.ep)
            cap = capacity(t, cfg)
            e_loc = cfg.moe.n_experts // plan.moe.ep
            d_pad = _ceil_to(cfg.d_model, cc.group)
            # encode as (site, layer, cfg, rows*d flat, axis): rows is
            # the per-peer block count e_loc*cap over the ep-sized hop
            out.append(("a2a", layer, cc, e_loc * cap * d_pad,
                        plan.moe.ep))
    if mode == "train" and pod > 1:
        cc = policy.resolve("grad")
        if cc is not None and cc.enabled:
            fsdp = mesh_shape.get("data", 1)
            n_shard = -(-cfg.param_count() // max(1, fsdp))
            out.append(("grad", None, cc,
                        _padded_payload(cc, n_shard, pod), pod))
    return out


def _payload_kind(cfg) -> int:
    """The dispatch payload's ``A2A_MODES`` kind: the model's dtype."""
    return 1 if cfg.dtype == "bfloat16" else 0


def _on_card() -> bool:
    import torch
    return torch.cuda.is_available()


def _limits(limits: Optional[smem.CardLimits]) -> smem.CardLimits:
    """``limits``, else the card's own (on a machine with one), else the
    H100's."""
    if limits is not None:
        return limits
    return smem.card_limits() if _on_card() else smem.H100


def launch_report(cfg, plan, policy: CommPolicy,
                  mesh_shape: Dict[str, int], *, global_batch: int,
                  seq: int, n_micro: int = 1, mode: str = "train",
                  card: bool = False,
                  limits: Optional[smem.CardLimits] = None,
                  subject: str = "") -> CheckReport:
    """The full pre-launch pass for one exact (config, policy, mesh,
    shapes) tuple: site lint, choreography for this mesh's axis sizes,
    and exact-payload layout checks and the card's budget for the
    kernel-backed paths.

    ``card`` says whether the launch would run the hand kernels (a launch
    on the GPU). The codec's launch contract, the fused sites' checks and
    the budget run only there, as the JAX package's VMEM checks run only
    under ``tpu`` — so with ``card=False`` the report is the JAX package's
    off-TPU report. ``limits`` are the card's (:func:`_limits`).
    """
    rep = CheckReport()
    policy = policy.bind(cfg.n_layers)
    rep.extend(sites.check_policy_sites(cfg, policy, subject))
    rep.extend(sites.check_qgrad_alignment(cfg, plan, policy, subject))
    tp = mesh_shape.get("model", 1)
    if tp >= 2:
        diags, n = choreography.check_choreography([tp])
        rep.extend(diags, n)
    payloads = _site_payloads(cfg, plan, policy, mesh_shape,
                              global_batch=global_batch, seq=seq,
                              n_micro=n_micro, mode=mode)
    if card:
        limits = _limits(limits)
    fused_keys = []
    for site, lyr, cc, n, axis in payloads:
        sub = (f"{subject} " if subject else "") + \
            f"site={site} layer={lyr} payload={n} axis={axis}"
        # wire layout at the REAL payload width (incl. lane warning)
        if site == "a2a":
            width = _ceil_to(cfg.d_model, cc.group)
        else:
            width = _ceil_to(-(-n // max(axis, 1)), cc.group)
        rep.extend(layout.check_config_layouts(cc, (width,), sub,
                                               lanes=True), 1)
        if not card:
            continue            # no hand kernels -> no card budget
        if cc.scheme == "fused" and axis > 1:
            bad = smem.check_fused_site(cc, site, axis, _payload_kind(cfg),
                                        sub)
            rep.extend(bad, 1)
            if bad and not any(d.rule == "SITE-FUSED-MESH" for d in bad):
                rep.extend([_fused_mesh(site, axis, n, sub)])
            fused_keys.append(smem.fused_mode(cc, site, _payload_kind(cfg)))
        elif cc.backend in ("cuda", "auto"):
            # library collectives around the CUDA codec: its contract
            rows = max(axis, 1) if site != "a2a" else n // width
            rep.extend(smem.check_codec_launch(cc.with_framed(False), rows,
                                               width, sub), 1)
    if fused_keys:
        sub = (f"{subject} " if subject else "") + "peer worlds"
        worlds = smem.peer_worlds(cfg, plan, mesh_shape,
                                  global_batch=global_batch, seq=seq,
                                  mode=mode)
        over = smem.check_peer_memory(worlds, math.prod(mesh_shape.values()),
                                      limits, sub)
        rep.extend(over, 1)
        if over:
            rep.extend([err(
                "SITE-FUSED-MESH",
                f"fused scheme cannot run on this mesh/payload: the peer "
                f"worlds of the ranks sharing a card do not fit it — use "
                f"--comm-scheme two_step (same schedule over library "
                f"collectives) or shrink the per-rank payload", sub)])
        rep.extend(smem.check_instances(smem.fused_instances(fused_keys),
                                        limits), 1)
    return rep


def _fused_mesh(site: str, axis: int, n: int, sub: str):
    return err("SITE-FUSED-MESH",
               f"fused scheme at site {site!r} cannot run on this "
               f"mesh/payload (axis={axis}, flat payload {n}): the "
               f"peer-push kernels do not serve it — use --comm-scheme "
               f"two_step (same schedule over library collectives)", sub)


def uses_fused(cfg, policy: CommPolicy) -> bool:
    """Whether any site the model addresses resolves to the fused
    scheme."""
    policy = policy.bind(cfg.n_layers)
    return any(cc is not None and cc.enabled and cc.scheme == "fused"
               for site, layer in sites.enumerate_sites(cfg)
               for cc in [policy.resolve(site, layer)])


def check_fused_request(cfg, plan, policy: CommPolicy,
                        mesh_shape: Dict[str, int], *, global_batch: int,
                        seq: int, n_micro: int = 1, mode: str = "train",
                        card: Optional[bool] = None,
                        limits: Optional[smem.CardLimits] = None,
                        context: str = "") -> None:
    """Fail-fast guard for fused-scheme launches (always on).

    Raises :class:`CommCheckError` with the offending diagnostics when
    any site resolves to the fused scheme on a mesh/payload the peer-push
    kernels cannot serve, instead of a failed launch inside a rank
    process after every rank has started. ``card`` defaults to
    ``torch.cuda.is_available()`` in the launcher's process: on the CPU
    the fused schemes run their plain versions, so only the scheme
    matrix can reject the launch there.
    """
    policy = policy.bind(cfg.n_layers)
    if not uses_fused(cfg, policy):
        return
    if card is None:
        card = _on_card()
    rep = launch_report(cfg, plan, policy, mesh_shape,
                        global_batch=global_batch, seq=seq,
                        n_micro=n_micro, mode=mode, card=card,
                        limits=limits, subject=context)
    if not rep.ok:
        raise CommCheckError(rep, context or "fused-scheme launch")


def preflight(cfg, plan, policy: CommPolicy, mesh_shape: Dict[str, int],
              *, check: bool, global_batch: int, seq: int,
              n_micro: int = 1, mode: str = "train",
              card: Optional[bool] = None, subject: str = "",
              tag: str = "[launch]", log=print) -> None:
    """What a launcher runs once, in its own process, before it builds
    weights or starts a rank process: with ``check`` (``--check``) the
    whole :func:`launch_report`, printed; always the fused-request guard
    (:func:`check_fused_request`), timed where a fused site resolves.
    Either one's error exits with code 2, the report printed."""
    if card is None:
        card = _on_card()
    if check:
        rep = launch_report(cfg, plan, policy, mesh_shape,
                            global_batch=global_batch, seq=seq,
                            n_micro=n_micro, mode=mode, card=card,
                            subject=subject)
        log(rep.format(f"{tag} commcheck", max_warnings=10))
        if not rep.ok:
            raise SystemExit(2)
    if not uses_fused(cfg, policy):
        return
    t0 = time.perf_counter()
    try:
        check_fused_request(cfg, plan, policy, mesh_shape,
                            global_batch=global_batch, seq=seq,
                            n_micro=n_micro, mode=mode, card=card,
                            context=subject)
    except CommCheckError as e:
        log(f"{tag} {e}")
        raise SystemExit(2)
    log(f"{tag} fused-request guard passed in "
        f"{time.perf_counter() - t0:.3f} s (card={card})")


# ---------------------------------------------------------------------------
# the sweeps
# ---------------------------------------------------------------------------

def core_report(card: bool = False,
                limits: Optional[smem.CardLimits] = None) -> CheckReport:
    """The shape-independent static pass (choreography / layouts / the
    codec's launch contract / frames). With ``card``, also the kernel
    instantiation table against ``limits`` and, on a machine with the
    card, the built libraries' attributes."""
    rep = CheckReport()
    diags, n = choreography.check_choreography(TP_VALUES)
    rep.extend(diags, n)
    diags, n = layout.check_layouts()
    rep.extend(diags, n)
    diags, n = smem.check_codec_static()
    rep.extend(diags, n)
    diags, n = frames.check_frames()
    rep.extend(diags, n)
    if card:
        limits = _limits(limits)
        diags, n = smem.check_budget(limits)
        rep.extend(diags, n)
        if _on_card():
            diags, n = smem.check_attrs(smem.read_attrs(), limits)
            rep.extend(diags, n)
    return rep


def all_report(trace: bool = False, card: bool = False,
               limits: Optional[smem.CardLimits] = None,
               device: Optional[str] = None) -> CheckReport:
    """--all: core pass + site lint for every shipped architecture x
    policy, + launch feasibility for every registry lowering pair on
    the production meshes. The trace lane's steps run on the card
    unless ``device`` is ``"cpu"``."""
    from repro_torch.configs import all_pairs, get_config, lowering_plan
    from repro_torch.models.config import INPUT_SHAPES
    from repro_torch.parallel.plan import make_plan
    if card:
        limits = _limits(limits)
    rep = core_report(card, limits)
    pols = shipped_policies()
    for arch, shape_name in all_pairs():
        cfg = get_config(arch)
        lp = lowering_plan(arch, shape_name)
        if lp.skip:
            continue
        shp = INPUT_SHAPES[shape_name]
        for mesh_shape in MESH_SHAPES:
            if "pod" in mesh_shape and lp.mode != "train":
                continue                # pod meshes only train
            try:
                plan = make_plan(cfg, tp=mesh_shape["model"],
                                 fsdp=mesh_shape.get("data", 1))
            except AssertionError:
                # the launcher itself rejects this (arch, mesh) combo
                # (head/dim divisibility) — not a shipped pair
                continue
            for pname, pol in pols.items():
                sub = f"{arch}/{shape_name}/{pname}/" \
                      f"{'x'.join(str(v) for v in mesh_shape.values())}"
                rep.extend(launch_report(
                    cfg, plan, pol, mesh_shape,
                    global_batch=shp.global_batch, seq=shp.seq_len,
                    n_micro=lp.n_micro or 1, mode=lp.mode, card=card,
                    limits=limits, subject=sub).diags, 1)
    if trace:
        from repro_torch.configs import ARCH_IDS
        for arch in ARCH_IDS:
            rep.extend(sites.trace_train_sites(
                arch, pols["paper"], f"trace {arch}/paper", device), 1)
    return rep


def pair_report(arch: str, policy: CommPolicy, policy_name: str,
                mesh_shape: Dict[str, int], *, global_batch: int = 8,
                seq: int = 128, n_micro: int = 1, card: bool = False,
                trace: bool = False,
                device: Optional[str] = None) -> CheckReport:
    """One (arch, policy, mesh) launch pair — the CLI single-pair mode.
    The trace lane's step runs on the card unless ``device`` is
    ``"cpu"``."""
    from repro_torch.configs import get_config
    from repro_torch.parallel.plan import make_plan
    cfg = get_config(arch)
    plan = make_plan(cfg, tp=mesh_shape.get("model", 1),
                     fsdp=mesh_shape.get("data", 1))
    rep = core_report()
    rep.extend(launch_report(cfg, plan, policy, mesh_shape,
                             global_batch=global_batch, seq=seq,
                             n_micro=n_micro, mode="train", card=card,
                             subject=f"{arch}/{policy_name}").diags, 1)
    if trace:
        rep.extend(sites.trace_train_sites(
            arch, policy, f"trace {arch}/{policy_name}", device), 1)
    return rep


def selftest_report() -> CheckReport:
    """Mutation fixtures: every rule must fire on its broken input."""
    from repro_torch.analysis.mutations import run_selftest
    rep = CheckReport()
    passed, failed = run_selftest()
    rep.checked = len(passed) + len(failed)
    for f in failed:
        rep.diags.append(err("SITE-TRACE",
                             f"mutation fixture did not fire: {f}",
                             "selftest"))
    return rep


def _parse_mesh(spec: str) -> Dict[str, int]:
    dims = [int(x) for x in spec.split(",")]
    shape = {"data": dims[0], "model": dims[1]}
    if len(dims) > 2 and dims[2]:
        shape = {"pod": dims[2], **shape}
    return shape


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="commcheck",
        description="static comm-safety analyzer (RDMA choreography, "
                    "wire layouts, policy-resolved comm sites)")
    ap.add_argument("--all", action="store_true",
                    help="every shipped config x policy x mesh pair")
    ap.add_argument("--selftest", action="store_true",
                    help="run the mutation fixtures")
    ap.add_argument("--trace", action="store_true",
                    help="also run a smoke train step of every arch "
                         "under a recording policy (slower)")
    ap.add_argument("--rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--card", action="store_true",
                    help="check as if the launches ran the hand kernels "
                         "on the card: the kernel table, the codec's "
                         "launch contract, the fused sites' peer worlds "
                         "(off by default: CPU launches run the plain "
                         "versions)")
    ap.add_argument("--device", default=None,
                    help="where --trace runs its train steps: the card "
                         "unless 'cpu' is given")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--policy", default="paper")
    ap.add_argument("--policy-file", default=None)
    ap.add_argument("--mesh", default="2,4",
                    help="data,model[,pod] for --arch mode")
    args = ap.parse_args(argv)

    if args.rules:
        w = max(len(r) for r in RULES)
        for rule, desc in RULES.items():
            print(f"{rule.ljust(w)}  {desc}")
        return 0

    if args.selftest:
        rep = selftest_report()
        print(rep.format("commcheck --selftest"))
        return 0 if rep.ok else 1

    if args.arch:
        from repro_torch.core.policy import load_policy_file
        pols = shipped_policies()
        if args.policy_file:
            pol, pname = load_policy_file(args.policy_file), \
                args.policy_file
        else:
            pol, pname = pols[args.policy], args.policy
        rep = pair_report(args.arch, pol, pname,
                          _parse_mesh(args.mesh), card=args.card,
                          trace=args.trace, device=args.device)
        print(rep.format(f"commcheck {args.arch} x {pname} "
                         f"x {args.mesh}", max_warnings=20))
        return 0 if rep.ok else 1

    rep = (all_report(trace=args.trace, card=args.card, device=args.device)
           if args.all else core_report(card=args.card))
    print(rep.format("commcheck --all" if args.all else "commcheck",
                     max_warnings=20))
    return 0 if rep.ok else 1


if __name__ == "__main__":
    sys.exit(main())
