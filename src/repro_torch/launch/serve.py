"""Serving launcher: batched prefill + greedy decode loop.

Runs on the GPU unless ``--device cpu`` is given; without a GPU it raises
rather than run on the CPU. Example (full width, random weights)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
      --batch 4 --prompt-len 128 --gen 16 --policy paper

``--mesh 1,TP`` serves at tensor parallelism TP, one rank a process: the
launcher starts TP rank processes (:func:`repro_torch.launch.mesh.
run_ranks`), each holding its shard of the weights, and fails when one
fails; rank 0 prints. On the card each rank takes card ``rank %
device_count``, and the ``fused`` sites run through the peer-push
kernels: the TP sites through the AllReduce, an MoE model's dispatch
(experts spread over the ranks) through the All2All; with ``--device
cpu`` the ranks run on gloo. For example::

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch moonshot-v1-16b-a3b --mesh 1,2 --batch 4 --prompt-len 128 \\
      --gen 16 --comm-scheme fused

``--mesh DATA,MODEL`` with ``DATA > 1`` serves DATA data-parallel
replicas of MODEL TP ranks each, ``DATA * MODEL`` rank processes: as the
JAX package's launcher does, the weights are a float32 flat store
sharded over the data axis (``make_plan(cfg, tp=MODEL, fsdp=DATA)``),
every block group gathered over it at every prefill and decode step (the
``qag`` site: quantized under the aggressive policy), and each replica
serves its rows of the batch (all of them when DATA does not divide
it). For example (two replicas on gloo)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
      --smoke --device cpu --mesh 2,1 --policy aggressive
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config, \
    get_smoke_config
from repro_torch.core.collectives import all_gather_rows
from repro_torch.core.comm_config import BACKENDS, SCHEMES
from repro_torch.core.policy import (BF16_POLICY, CommPolicy,
                                     aggressive_policy, describe_policy,
                                     load_policy_file, paper_policy,
                                     with_backend, with_scheme)
from repro_torch.launch import mesh
from repro_torch.models.model import greedy_next_token
from repro_torch.parallel.axis import MeshAxes
from repro_torch.parallel.plan import make_plan
from repro_torch.parallel.shardings import init_params, init_store
from repro_torch.train.data import DataConfig, make_dataset
from repro_torch.train.serve_step import (local_rows, make_cache_init,
                                          make_decode_step, make_prefill)

POLICIES = {"paper": paper_policy, "bf16": lambda: BF16_POLICY,
            "aggressive": aggressive_policy}
#: bound on the relative prefill/decode divergence of the next-token
#: logits (see :func:`prefill_decode_agreement`). It must pass the
#: rounding noise of the coarsest policy: on qwen3-14b at full width with
#: random bf16 weights (``chip_smoke.py``, one H100) a correct cache gives
#: about 0.02 unquantized, 0.03 under the paper policy (int8) and 0.2
#: under the aggressive one (int5, Eq.-1 scales). A cache that loses the
#: earlier positions' values or slots gives more than 1
#: (``tests/test_torch_serve.py``).
AGREEMENT_REL_TOL = 0.5


def resolve_device(name: Optional[str]) -> torch.device:
    """``cpu`` only when asked for; anything else needs a GPU."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this launcher runs on the GPU "
                           "unless --device cpu is given")
    return torch.device(name or "cuda")


def build_policy(name: str = "paper", policy_file: Optional[str] = None,
                 backend: str = "auto",
                 scheme: Optional[str] = None) -> CommPolicy:
    base = load_policy_file(policy_file) if policy_file \
        else POLICIES[name]()
    policy = with_backend(base, backend)
    return with_scheme(policy, scheme) if scheme else policy


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefill_decode_agreement(prefill_logits: torch.Tensor,
                             decode_logits: torch.Tensor,
                             prefill_tokens: torch.Tensor,
                             decode_tokens: torch.Tensor,
                             vocab: int) -> Dict:
    """Hold the decode path's first generated token against the prefill's.

    The decode step that consumed the last prompt token through the cache
    and the prefill of the whole prompt predict the same token from the
    same weights. They run it through matmuls of other shapes (M = B*S
    against M = B), whose bf16 results can differ in the last bit, and a
    quantized site can turn such a bit into a code step. So:

    - the logits must agree to ``AGREEMENT_REL_TOL``: the norm of their
      difference over the norm of the prefill's centred logits, per row.
      A cache that loses, misplaces or mis-rotates positions moves them by
      about their whole spread;
    - the tokens must be equal in every row whose prefill top-2 margin
      exceeds twice the row's largest logit difference (there the
      difference cannot move the argmax), and in every row whose logits
      are bit-identical.

    Raises AssertionError otherwise; returns the measured numbers.
    """
    p = prefill_logits[:, :vocab].float()
    d = decode_logits[:, :vocab].float()
    diff = (p - d).abs().amax(-1)
    top2 = torch.topk(p, 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    rel = (torch.linalg.vector_norm(p - d, dim=-1)
           / torch.linalg.vector_norm(p - p.mean(-1, keepdim=True), dim=-1))
    held = (margin > 2 * diff) | (diff == 0)
    same = prefill_tokens == decode_tokens
    res = {"rel_divergence": rel.tolist(), "max_logit_diff": diff.tolist(),
           "margin": margin.tolist(), "rows_held": int(held.sum())}
    if not bool((rel <= AGREEMENT_REL_TOL).all()):
        raise AssertionError(
            f"prefill and decode logits diverge by {res['rel_divergence']} "
            f"(> {AGREEMENT_REL_TOL}): KV-cache seeding drift")
    if not bool((same | ~held).all()):
        raise AssertionError(
            f"decode's first post-prompt token {decode_tokens.tolist()} != "
            f"prefill's {prefill_tokens.tolist()} in a row whose top-2 "
            f"margin {res['margin']} exceeds twice the logit difference "
            f"{res['max_logit_diff']}")
    return res


def _full_logits(logits: torch.Tensor, group) -> torch.Tensor:
    """(B, v_loc) shards -> (B, tp * v_loc), every rank's in rank order."""
    shards = all_gather_rows(logits, group)            # (tp, B, v_loc)
    return shards.transpose(0, 1).reshape(logits.shape[0], -1)


def _gather_rows(x: torch.Tensor, batch: int, data_group) -> np.ndarray:
    """This replica's rows (B_loc, ...) -> the global batch's (B, ...),
    gathered over the data axis (a replicated batch: replica 0's)."""
    if data_group is None:
        return x.cpu().numpy()
    rows = all_gather_rows(x, data_group).cpu().numpy()
    return rows.reshape(-1, *x.shape[1:])[:batch]


def serve(params, cfg, plan, policy: CommPolicy, *, batch: int,
          prompt_len: int, gen: int, device: torch.device, seed: int = 0,
          label: str = "", log=print, group=None,
          keep_caches: bool = False, data_group=None,
          window_override: Optional[int] = None,
          cache_len: Optional[int] = None,
          record: Optional[list] = None) -> Dict:
    """Prefill a batch of synthetic prompts, then decode: the prompt is
    teacher-forced through the cache, then ``gen`` tokens are generated.
    ``group`` is the model axis (``params`` this rank's shard);
    at ``plan.fsdp > 1`` ``params`` is this rank's shard of the flat
    store, gathered over the data axis ``data_group``
    (:func:`repro_torch.train.serve_step.make_prefill`), and each data
    replica serves its rows of the batch
    (:func:`repro_torch.train.serve_step.local_rows`). Every rank
    of the mesh calls this, and a barrier over all of them precedes the
    prefill and the decode loop; the times are this rank's clock.
    ``window_override`` windows every self-attention block but a local
    one; ``cache_len`` (default ``prompt_len + gen``) sizes the decode
    rings, so a ``cache_len`` of the window makes them wrap. ``record``,
    if given, gets each forward's (B_loc, v_loc) logits appended, the
    prefill's first.

    A model with an encoder or cross-attention is
    given the stream's ``enc_embeds`` (B, n_ctx, d_model) at the prefill
    and at every decode step.

    Checks that decode's first generated token agrees with prefill's
    prediction (:func:`prefill_decode_agreement`): a mismatch means the
    cache was seeded or rolled wrong. Not for an MoE model: there the two
    paths route with different capacities (``capacity(B * S)`` against
    ``capacity(B)``, which at decode drops routes that prefill keeps), so
    their logits differ by design; the routes dropped at prefill and at
    decode are counted instead. The agreement is checked on each
    replica's rows; the first and generated tokens returned are the
    global batch's, gathered over the data axis. With ``keep_caches`` the
    result also holds the decode caches as the last step left them
    (``"caches"``).
    """
    enc = cfg.encoder.n_ctx if (cfg.is_enc_dec or cfg.has_cross) else None
    data = make_dataset(DataConfig(vocab=cfg.vocab, seq_len=prompt_len,
                                   global_batch=batch, seed=seed,
                                   enc_ctx=enc,
                                   d_model=cfg.d_model)).batch(0)
    rows = local_rows(batch, data_group)
    prompts = torch.from_numpy(data["tokens"][rows]).to(device)
    # the stub frontend's embeddings, given to the prefill and to every
    # decode step
    embeds = (torch.from_numpy(data["enc_embeds"][rows]).to(device)
              if enc else None)
    b_loc = prompts.shape[0]
    axes = MeshAxes(model=group, data=data_group)
    kw = dict(group=group, data_group=data_group,
              window_override=window_override)

    moe = cfg.moe is not None
    pstats, dstats = {}, {}
    prefill = make_prefill(cfg, plan, policy, stats=pstats, **kw)
    _sync(device)
    mesh.barrier_all(axes)
    t0 = time.perf_counter()
    prefill_logits = prefill(params, prompts, embeds)
    first = greedy_next_token(prefill_logits, plan, group)
    if record is not None:
        record.append(prefill_logits)
    _sync(device)
    ttft = time.perf_counter() - t0
    replicas = "" if data_group is None else (
        f", {b_loc} a replica" if b_loc < batch else ", every replica all")
    log(f"[serve{label}] TTFT (prefill {prompt_len} toks x{batch}"
        f"{replicas}): {ttft * 1000:.1f} ms")

    caches = make_cache_init(cfg, plan, batch, cache_len or prompt_len + gen,
                             device, data_group)()
    step = make_decode_step(cfg, plan, policy, stats=dstats, **kw)
    out, agree = [], None
    tok = prompts[:, :1]
    step_ms = []
    steps = prompt_len + gen - 1
    _sync(device)
    mesh.barrier_all(axes)
    for i in range(steps):
        _sync(device)
        t0 = time.perf_counter()
        logits, caches = step(params, caches, tok, embeds)
        nt = greedy_next_token(logits, plan, group)
        if record is not None:
            record.append(logits)
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1000)
        if i + 1 < prompt_len:
            tok = prompts[:, i + 1:i + 2]          # teacher-forced prompt
        else:
            if agree is None and not moe:
                agree = prefill_decode_agreement(
                    _full_logits(prefill_logits, group),
                    _full_logits(logits, group), first, nt, cfg.vocab)
            tok = nt[:, None]
            out.append(nt)
    gen_toks = _gather_rows(
        torch.stack(out, 1) if out else torch.zeros(
            (b_loc, 0), dtype=torch.int64, device=device), batch, data_group)
    steady = np.asarray(step_ms[1:]) if steps > 1 else np.full(1, np.nan)
    med, p90 = float(np.median(steady)), float(np.percentile(steady, 90))
    log(f"[serve{label}] {steps} decode steps: first {step_ms[0]:.1f} ms; "
        f"steady median {med:.2f} ms/step, p90 {p90:.2f} ms/step "
        f"({steady.size} steps)")
    if agree is not None:
        log(f"[serve{label}] prefill/decode agreement: logit divergence "
            f"{agree['rel_divergence']}; first generated token matches "
            f"prefill in the {agree['rows_held']} of {b_loc} rows held "
            f"(top-2 margins {agree['margin']})")
    routes = {}
    if moe:
        routes = {f"{k}_{ph}": int(st.get(k, 0)) for ph, st in
                  (("prefill", pstats), ("decode", dstats))
                  for k in ("routes", "dropped")}
        log(f"[serve{label}] MoE routes dropped over capacity: prefill "
            f"{routes['dropped_prefill']} of {routes['routes_prefill']}, "
            f"decode {routes['dropped_decode']} of "
            f"{routes['routes_decode']} (no prefill/decode agreement "
            f"check: the capacities differ)")
    assert np.all((gen_toks >= 0) & (gen_toks < cfg.vocab))
    log(f"[serve{label}] generated tokens (first row): {gen_toks[0][:16]}")
    return {"ttft_ms": ttft * 1000, "first_step_ms": step_ms[0],
            "step_ms_median": med, "step_ms_p90": p90, "decode_steps": steps,
            "first_tokens": _gather_rows(first, batch, data_group),
            "generated": gen_toks,
            "agreement": agree, **routes,
            **({"caches": caches} if keep_caches else {})}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--policy", default="paper", choices=list(POLICIES))
    ap.add_argument("--policy-file", default=None,
                    help="JSON policy artifact (see configs/policies/); "
                         "overrides --policy")
    ap.add_argument("--codec-backend", default="auto", choices=BACKENDS,
                    help="wire codec backend for every comm site")
    ap.add_argument("--comm-scheme", default=None, choices=SCHEMES,
                    help="override the collective schedule at every "
                         "enabled site")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default, raises without a GPU) or 'cpu'")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the prompts")
    ap.add_argument("--mesh", default="1,1",
                    help="DATA,MODEL: DATA * MODEL > 1 serves one rank a "
                         "process, DATA > 1 data-parallel replicas "
                         "gathering their store over the data axis")
    # set by the launcher for each rank process it starts
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    data, model = mesh.parse_mesh(args.mesh)
    world = data * model
    device = resolve_device(args.device)
    if world > 1 and args.rank is None:
        argv = list(sys.argv[1:] if argv is None else argv)
        mesh.run_ranks(lambda r, store: [
            sys.executable, "-m", "repro_torch.launch.serve", *argv,
            "--rank", str(r), "--rendezvous", store], world)
        return {"ranks": world}
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    plan = make_plan(cfg, tp=model, fsdp=data)
    rank = args.rank or 0
    _, data_rank, model_rank = mesh.mesh_coord(rank, data, model)
    if world > 1:
        device = mesh.rank_device(rank, device)
    rows = args.batch // data if args.batch % data == 0 else args.batch
    axes = mesh.init_mesh(
        data, model, 0, rank, args.rendezvous, device,
        mesh.site_row_bytes(cfg, plan, rows, args.prompt_len), plan.moe)
    log = print if rank == 0 else (lambda *a, **k: None)
    try:
        policy = build_policy(args.policy, args.policy_file,
                              args.codec_backend, args.comm_scheme)
        log(describe_policy(policy, cfg.n_layers))
        if data > 1:          # this rank's shard of the float32 flat store
            params = init_store(cfg, plan, args.seed, device,
                                rank=model_rank, data_rank=data_rank)
        else:
            params = init_params(cfg, plan, args.seed, device,
                                 getattr(torch, cfg.dtype), rank=model_rank)
        res = serve(params, cfg, plan, policy, batch=args.batch,
                    prompt_len=args.prompt_len, gen=args.gen, device=device,
                    seed=args.seed, log=log, group=axes.model,
                    data_group=axes.data)
    finally:
        mesh.close_mesh(axes)
    log(f"[serve] OK{f' (rank 0 of {world})' if world > 1 else ''}")
    return res


if __name__ == "__main__":
    main()
