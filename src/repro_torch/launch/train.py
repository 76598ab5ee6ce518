"""Training launcher: a model of any block kind on a ``DATA,MODEL[,POD]``
mesh of rank processes.

Runs on the GPU unless ``--device cpu`` is given; without a GPU it raises
rather than run on the CPU. The flags are the JAX launcher's. Example
(the smoke config on the CPU, two data ranks on gloo)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --smoke --device cpu --steps 3 --seq 64 --batch 4 --mesh 2,1

A mesh of more than one rank starts one rank process a rank
(:func:`repro_torch.launch.mesh.run_ranks`), rank ``r`` at coordinate
``(pod, data, model)`` in JAX's row-major order, each on card ``r %
device_count`` (ranks that share a card take turns on it); rank 0
prints. The store is the flat ZeRO store, float32, from ``--seed``
(:func:`repro_torch.parallel.shardings.init_store`). The last line is the
JSON object of the JAX launcher, ``{"first_loss": ..., "last_loss":
...}``.

An MoE model's experts spread over the model axis (ep = gcd(experts,
MODEL)); its dispatch All2All runs inside the step, forward and backward,
and its load-balance loss enters the loss at weight 0.01. For example
(moonshot's smoke config, two expert-parallel ranks on gloo)::

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch moonshot-v1-16b-a3b --smoke --device cpu --steps 3 --mesh 1,2

A model with an encoder or cross-attention blocks (whisper-tiny,
llama-3.2-vision-11b) trains on the stream's stub frontend embeddings
(``enc_embeds``, B x n_ctx x d_model float32, drawn after each batch's
tokens), as the JAX launcher's; for example::

  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \\
      --smoke --device cpu --steps 2 --seq 32 --batch 2

``--framed-bridge BITS`` runs the pod hop of the gradient sync at its
own width, in self-describing frames (header + CRC32C a row,
:mod:`repro_torch.core.frame`), while every other site keeps the policy's
config; for example (two pods on gloo)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --smoke --device cpu --steps 2 --mesh 1,1,2 --framed-bridge 4

Before it builds weights or starts a rank process, the launcher runs the
fused-request guard (:func:`repro_torch.analysis.commcheck.
check_fused_request`, where a site resolves to ``fused``) and, with
``--check``, the whole pre-launch pass (``launch_report``); on the card
both hold the launch to the hand kernels' budget. Either one's error
exits with code 2.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, List, Optional

import torch

from repro_torch.analysis import commcheck
from repro_torch.configs.registry import ARCH_IDS, get_config, \
    get_smoke_config
from repro_torch.core.comm_config import BACKENDS, SCHEMES
from repro_torch.core.policy import (BF16_POLICY, CommPolicy,
                                     aggressive_policy, depth_policy,
                                     describe_policy, load_policy_file,
                                     paper_policy, with_backend,
                                     with_framed_bridge, with_scheme)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.serve import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.axis import MeshAxes, axis_rank
from repro_torch.parallel.plan import ShardingPlan, make_plan
from repro_torch.parallel.shardings import init_store
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.data import DataConfig, make_dataset
from repro_torch.train.optim import OptimConfig, init_opt_state, tree_map
from repro_torch.train.train_step import (local_batch, make_train_step_fn,
                                          wants_grad_ef, wants_qgrad_ef)

POLICIES = {"paper": paper_policy, "bf16": lambda: BF16_POLICY,
            "aggressive": aggressive_policy, "depth": depth_policy}


def build_policy(name: str = "paper", policy_file: Optional[str] = None,
                 backend: str = "auto", scheme: Optional[str] = None,
                 grad_ef: bool = False,
                 framed_bridge: Optional[int] = None) -> CommPolicy:
    base = load_policy_file(policy_file) if policy_file \
        else POLICIES[name]()
    policy = with_backend(base, backend)
    if scheme:
        policy = with_scheme(policy, scheme)
    if framed_bridge is not None:
        policy = with_framed_bridge(policy, framed_bridge)
    if grad_ef:
        policy = dataclasses.replace(policy, grad_ef=True)
    return policy


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg: ModelConfig, plan: ShardingPlan, policy: CommPolicy,
          opt_cfg: OptimConfig, mesh: MeshAxes, *, batch: int, seq: int,
          steps: int, device: torch.device, seed: int = 0, n_micro: int = 1,
          log_every: int = 10, resume: Optional[str] = None,
          ckpt: Optional[str] = None, log=print, store=None,
          on_step=None, stats: Optional[Dict] = None) -> Dict:
    """Train ``steps`` steps on this rank (every rank of ``mesh`` calls
    it) -> ``{"history": [...], "step_ms": [...], "store", "opt"}``.

    The weights are ``resume``'s, else ``store`` (this rank's flat store,
    trained in place), else :func:`~repro_torch.parallel.shardings.
    init_store`'s from ``seed``. ``on_step(i, store, opt, metrics)``, if
    given, runs after each step (a check reads the state there);
    ``stats``, if given, gathers an MoE model's routing counts. Each step
    is timed on the host, the card synchronised before and after.
    """
    rank = axis_rank(mesh.model)
    data_rank = axis_rank(mesh.data)
    grad_ef = wants_grad_ef(policy, mesh)
    qgrad_ef = wants_qgrad_ef(policy, plan)
    if resume:
        store, opt, start = ckpt_lib.restore(resume, device, rank, data_rank,
                                             plan.fsdp)
        if grad_ef and "ef" not in opt:     # a checkpoint without EF
            opt["ef"] = tree_map(torch.zeros_like, store)
        elif not grad_ef:
            opt.pop("ef", None)
        if qgrad_ef and "qef" not in opt:
            opt["qef"] = tree_map(lambda p: torch.zeros(
                (p.shape[0], p.shape[1] * plan.fsdp), dtype=torch.float32,
                device=device), store)
        elif not qgrad_ef:
            opt.pop("qef", None)
        log(f"[train] resumed from {resume} @ step {start}")
    else:
        if store is None:
            store = init_store(cfg, plan, seed, device, rank, data_rank)
        opt = init_opt_state(store, opt_cfg, grad_ef=grad_ef,
                             qgrad_ef=qgrad_ef, fsdp=plan.fsdp)
        start = 0
    step_fn = make_train_step_fn(cfg, plan, policy, opt_cfg, mesh, n_micro,
                                 stats)
    enc = cfg.encoder.n_ctx if (cfg.is_enc_dec or cfg.has_cross) else None
    ds = make_dataset(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                 global_batch=batch, seed=seed, enc_ctx=enc,
                                 d_model=cfg.d_model))
    history: List[Dict] = []
    step_ms: List[float] = []
    t0 = time.time()
    for i in range(start, steps):
        b = local_batch(ds.batch(i), mesh, device)
        _sync(device)
        mesh_lib.barrier_all(mesh)
        t1 = time.perf_counter()
        store, opt, metrics = step_fn(store, opt, b)
        _sync(device)
        step_ms.append((time.perf_counter() - t1) * 1000)
        if on_step is not None:
            on_step(i, store, opt, metrics)
        if i % log_every == 0 or i == steps - 1:
            rec = {k: float(v) for k, v in metrics.items()}
            history.append({"step": i, **rec})
            log(f"[train] step {i:5d} loss {rec['loss']:8.4f} "
                f"gnorm {rec['grad_norm']:8.3f} lr {rec['lr']:.2e} "
                f"({time.time() - t0:6.1f}s)", flush=True)
    if ckpt:
        ckpt_lib.save(ckpt, store, opt, steps, mesh)
        log(f"[train] saved checkpoint to {ckpt}")
    return {"history": history, "step_ms": step_ms, "store": store,
            "opt": opt}


def main(argv=None) -> Optional[Dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", default="1,1",
                    help="data,model[,pod] sizes: one rank process a rank "
                         "(a pod axis turns on the cross-pod grad sync)")
    ap.add_argument("--policy", default="paper", choices=list(POLICIES))
    ap.add_argument("--policy-file", default=None,
                    help="JSON policy artifact (see configs/policies/); "
                         "overrides --policy")
    ap.add_argument("--framed-bridge", type=int, default=None,
                    metavar="BITS",
                    help="run the pod-bridge gradient hop at its own bit "
                         "width with the self-describing frame header "
                         "(core/frame) while every other site keeps the "
                         "policy's config")
    ap.add_argument("--grad-ef", action="store_true",
                    help="error-feedback gradient compression")
    ap.add_argument("--codec-backend", default="auto", choices=BACKENDS,
                    help="wire codec backend for every comm site")
    ap.add_argument("--comm-scheme", default=None, choices=SCHEMES,
                    help="override the collective schedule at every "
                         "enabled site")
    ap.add_argument("--check", action="store_true",
                    help="run the full commcheck pre-launch pass (site "
                         "lint, choreography, layouts, the card's budget) "
                         "and exit 2 before building anything if a rule "
                         "fires")
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default, raises without a GPU) or 'cpu'")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the batches")
    # set by the launcher for each rank process it starts
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    data, model, pod = mesh_lib.parse_train_mesh(args.mesh)
    device = resolve_device(args.device)
    world = max(pod, 1) * data * model
    plan = make_plan(cfg, tp=model, fsdp=data)
    policy = build_policy(args.policy, args.policy_file, args.codec_backend,
                          args.comm_scheme, args.grad_ef, args.framed_bridge)
    shape = {"data": data, "model": model}
    if pod:
        shape = {"pod": pod, **shape}
    if args.rank is None:       # once, in the launcher's process
        commcheck.preflight(
            cfg, plan, policy, shape, check=args.check,
            global_batch=args.batch, seq=args.seq, n_micro=args.n_micro,
            mode="train", card=device.type == "cuda",
            subject=f"{args.arch}/{args.policy_file or args.policy}",
            tag="[train]")
    if world > 1 and args.rank is None:
        argv = list(sys.argv[1:] if argv is None else argv)
        mesh_lib.run_ranks(lambda r, store: [
            sys.executable, "-m", "repro_torch.launch.train", *argv,
            "--rank", str(r), "--rendezvous", store], world)
        return None
    rank = args.rank or 0
    opt_cfg = OptimConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                          total_steps=args.steps)
    if world > 1:
        device = mesh_lib.rank_device(rank, device)
    b_loc = args.batch // (max(pod, 1) * data) or args.batch
    mesh = mesh_lib.init_mesh(
        data, model, pod, rank, args.rendezvous, device,
        mesh_lib.site_row_bytes(cfg, plan, b_loc, args.seq), plan.moe)
    log = print if rank == 0 else (lambda *a, **k: None)
    try:
        log(f"[train] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
            f"mesh {shape}, policy={args.policy_file or args.policy}, "
            f"device {device}")
        log(describe_policy(policy, cfg.n_layers))
        res = train(cfg, plan, policy, opt_cfg, mesh, batch=args.batch,
                    seq=args.seq, steps=args.steps, device=device,
                    seed=args.seed, n_micro=args.n_micro,
                    log_every=args.log_every, resume=args.resume,
                    ckpt=args.ckpt, log=log)
    finally:
        mesh_lib.close_mesh(mesh)
    hist = res["history"]
    log(json.dumps({"first_loss": hist[0]["loss"],
                    "last_loss": hist[-1]["loss"]}))
    return res


if __name__ == "__main__":
    main()
