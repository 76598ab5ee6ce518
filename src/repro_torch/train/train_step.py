"""The training step of one rank: forward and backward, the gradient
syncs, and the ZeRO AdamW update.

Gradient communication, as in the JAX package:

* within a pod, over ``data``: the FSDP gather's backward is the exact
  reduce-scatter, which sums the data ranks' gradients and lands them on
  the rank's shard. With the ``qgrad_rs`` site active (a policy that sets
  it, ``fsdp > 1``) the backward instead taps the full-length per-rank
  gradients (zero ``delta`` leaves added to the detached gathered
  weights) and the quantized reduce-scatter runs after the backward,
  with its error-feedback residual ``qef`` when the policy asks for EF;
* over ``model``: the gradients of TP-replicated parameters (the norms'
  gains) get the exact sum (Megatron's LN-grad all-reduce);
* across pods: the paper's quantized two-step AllReduce of the sharded
  flat gradients (only 1 / fsdp of them cross the bridge), with its EF
  residual ``ef`` under ``grad_ef``; at the ``bridge`` site's config when
  the policy sets one (:func:`pod_grad_config`), framed or not.

Every rank seeds its backward with ``raw / (model * data [* pod])``:
with the exact sum as the transpose of every sum over ranks, the
gradients are those of the mean loss, as under JAX's ``shard_map``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.collectives import (all_reduce_sum, compressed_psum,
                                          compressed_psum_ef, group_size,
                                          quantized_reduce_scatter,
                                          quantized_reduce_scatter_ef)
from repro_torch.core.comm_config import NO_COMPRESSION, CommConfig
from repro_torch.core.policy import CommPolicy
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import forward_train, lm_loss, param_groups
from repro_torch.parallel.axis import MeshAxes, axis_rank
from repro_torch.parallel.plan import ShardingPlan
from repro_torch.train.optim import (OptimConfig, Tree, adamw_update,
                                     global_grad_norm, tree_map)


def batch_slice(global_batch: int, mesh: MeshAxes) -> slice:
    """The rows of the global batch this rank trains on: sharded over
    (pod, data) when that divides it, else over data alone, else all
    (the JAX ``batch_spec``)."""
    pod = group_size(mesh.pod) if mesh.multi_pod else 1
    data = group_size(mesh.data)
    p = axis_rank(mesh.pod) if mesh.multi_pod else 0
    d = axis_rank(mesh.data)
    if global_batch % (pod * data) == 0:
        n, i = global_batch // (pod * data), p * data + d
    elif global_batch % data == 0:
        n, i = global_batch // data, d
    else:
        return slice(0, global_batch)
    return slice(i * n, (i + 1) * n)


def local_batch(batch: Dict[str, np.ndarray], mesh: MeshAxes,
                device) -> Dict[str, torch.Tensor]:
    """The global batch (numpy) -> this rank's rows of every key on
    ``device``: the tokens and labels int64, the stub frontend's
    ``enc_embeds`` float32."""
    sl = batch_slice(batch["tokens"].shape[0], mesh)
    return {k: torch.from_numpy(np.ascontiguousarray(v[sl])).to(
        device=device,
        dtype=torch.float32 if k == "enc_embeds" else torch.int64)
        for k, v in batch.items()}


def _replicated_mask(cfg: ModelConfig, plan: ShardingPlan) -> Dict:
    """Which stored parameters are TP-replicated copies."""
    return {g: {n: (sp.tp_dim is None and sp.moe_fold is None)
                for n, sp in specs.items()}
            for g, (_, specs) in param_groups(cfg, plan).items()}


def make_loss_fn(cfg: ModelConfig, plan: ShardingPlan, policy: CommPolicy,
                 mesh: MeshAxes, n_micro: int = 1,
                 aux_weight: float = 0.01, stats: Optional[Dict] = None):
    """(store, deltas, batch) -> (seed loss, raw loss) of this rank; an
    MoE model's aux loss enters at ``aux_weight``, and ``stats``, if
    given, gathers its routing counts in the forward. The batch's
    ``enc_embeds``, when it has them, go to the forward, sliced with the
    tokens under ``n_micro > 1``."""
    dtype = getattr(torch, cfg.dtype)
    denom = group_size(mesh.model) * group_size(mesh.data)
    if mesh.multi_pod:
        denom *= group_size(mesh.pod)

    def one_micro(store, deltas, tokens, labels, enc):
        hidden, unemb, aux = forward_train(
            store, tokens, cfg, plan, policy, dtype=dtype, group=mesh.model,
            data_group=mesh.data, grad_deltas=deltas, stats=stats,
            enc_embeds=enc)
        return lm_loss(hidden, unemb, labels, cfg, plan, aux, aux_weight,
                       group=mesh.model)

    def loss_fn(store, deltas, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        enc = batch.get("enc_embeds")
        if n_micro == 1:
            raw = one_micro(store, deltas, tokens, labels, enc)
        else:
            b = tokens.shape[0]
            assert b % n_micro == 0, (b, n_micro)
            mb = b // n_micro
            raw = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(n_micro):
                sl = slice(i * mb, (i + 1) * mb)
                raw = raw + one_micro(store, deltas, tokens[sl], labels[sl],
                                      None if enc is None else enc[sl])
            raw = raw / n_micro
        return raw / denom, raw

    return loss_fn


def pod_grad_config(policy: CommPolicy) -> CommConfig:
    """The config of the cross-pod sync (one axis, so the hierarchical
    schemes run their one-axis forms): the ``bridge`` site's when it is
    set (the SDP4Bit-style mixed-tier split: the pod hop at its own
    width, typically framed, :func:`repro_torch.core.policy.
    with_framed_bridge`), else the grad site's."""
    return (policy.resolve("bridge") or policy.resolve("grad")
            or NO_COMPRESSION)


def wants_grad_ef(policy: CommPolicy, mesh: MeshAxes) -> bool:
    """Whether training ``policy`` on ``mesh`` carries the pod EF residual
    ``ef``: the policy asks for EF and the grad site crosses pods
    compressed."""
    return bool(policy.grad_ef and mesh.multi_pod
                and pod_grad_config(policy).enabled)


def qgrad_rs_config(policy: CommPolicy) -> CommConfig:
    return policy.resolve("qgrad_rs") or NO_COMPRESSION


def _qgrad_active(policy: CommPolicy, plan: ShardingPlan) -> bool:
    """Whether the explicit quantized gradient RS replaces the exact one
    of the gather's backward."""
    cfg = qgrad_rs_config(policy)
    return bool(cfg.enabled and cfg.scheme != "nccl" and plan.fsdp > 1)


def wants_qgrad_ef(policy: CommPolicy, plan: ShardingPlan) -> bool:
    """Whether the qgrad RS carries the ``qef`` residual."""
    return _qgrad_active(policy, plan) and bool(policy.grad_ef)


def _sorted_leaves(tree: Tree):
    """(group, name) of every leaf in the JAX pytree's order (sorted
    keys), the same on every rank."""
    return [(g, n) for g in sorted(tree) for n in sorted(tree[g])]


def make_train_step_fn(cfg: ModelConfig, plan: ShardingPlan,
                       policy: CommPolicy, opt_cfg: OptimConfig,
                       mesh: MeshAxes, n_micro: int = 1,
                       stats: Optional[Dict] = None):
    """step(store, opt_state, batch) -> (store, opt_state, metrics) of
    this rank; ``batch`` is its local rows (:func:`local_batch`). The
    store and the optimizer state are updated in place; ``opt_state`` is
    :func:`repro_torch.train.optim.init_opt_state` with
    ``wants_grad_ef(policy, mesh)`` and ``wants_qgrad_ef(policy, plan)``.
    ``stats``, if given, gathers the MoE routing counts of every step.
    """
    loss_fn = make_loss_fn(cfg, plan, policy, mesh, n_micro, stats=stats)
    pod_cfg = pod_grad_config(policy)
    qgrad_cfg = qgrad_rs_config(policy)
    use_qgrad = _qgrad_active(policy, plan)
    use_qgrad_ef = wants_qgrad_ef(policy, plan)
    use_ef = wants_grad_ef(policy, mesh)
    mask = _replicated_mask(cfg, plan)
    data_n = group_size(mesh.data)
    pod_n = group_size(mesh.pod) if mesh.multi_pod else 1

    @torch.enable_grad()          # whatever the caller's grad mode
    def backward(store: Tree, batch: Dict):
        """-> (this rank's gradients, raw loss)."""
        if use_qgrad:
            # zero full-length deltas: their gradients are the per-rank
            # gradients before any reduce-scatter
            leaves = tree_map(lambda v: torch.zeros(
                (v.shape[0], v.shape[1] * plan.fsdp), dtype=v.dtype,
                device=v.device, requires_grad=True), store)
            seed, raw = loss_fn(store, leaves, batch)
        else:
            leaves = tree_map(lambda v: v.detach().requires_grad_(True),
                              store)
            seed, raw = loss_fn(leaves, None, batch)
        seed.backward()
        return tree_map(lambda v: v.grad, leaves), raw.detach()

    def step(store: Tree, opt_state: Dict, batch: Dict):
        grads, raw = backward(store, batch)

        # model axis: the exact sum of the TP-replicated copies' grads
        for g, n in _sorted_leaves(grads):
            if mask[g][n]:
                grads[g][n] = all_reduce_sum(grads[g][n], mesh.model)

        # within the pod: the quantized (EF) reduce-scatter over data of
        # the full-length grads, landing them on the rank's shard
        new_qef = None
        if use_qgrad:
            if use_qgrad_ef:
                new_qef = {g: {} for g in grads}
            for g, n in _sorted_leaves(grads):
                gr = grads[g][n].to(torch.float32)
                if use_qgrad_ef:      # the residual updated in place
                    res = opt_state["qef"][g][n]
                    grads[g][n], r = quantized_reduce_scatter_ef(
                        gr, res, qgrad_cfg, mesh.data)
                    new_qef[g][n] = res.copy_(r)
                    del r
                else:
                    grads[g][n] = quantized_reduce_scatter(gr, qgrad_cfg,
                                                           mesh.data)
                del gr

        # across pods: the quantized two-step AllReduce of the shards,
        # with the EF residual under grad_ef
        new_ef = None
        if mesh.multi_pod:
            if use_ef:
                new_ef = {g: {} for g in grads}
            for g, n in _sorted_leaves(grads):
                if use_ef:            # the residual updated in place
                    res = opt_state["ef"][g][n]
                    grads[g][n], r = compressed_psum_ef(
                        grads[g][n], res, pod_cfg, mesh.pod)
                    new_ef[g][n] = res.copy_(r)
                    del r
                else:
                    grads[g][n] = compressed_psum(grads[g][n], pod_cfg,
                                                  mesh.pod)

        sq = all_reduce_sum(all_reduce_sum(global_grad_norm(grads),
                                           mesh.data), mesh.model)
        if mesh.multi_pod:
            sq = all_reduce_sum(sq, mesh.pod)
        gnorm = torch.sqrt(sq)

        store, new_opt, lr = adamw_update(store, grads, opt_state, opt_cfg,
                                          gnorm)
        if new_ef is not None:
            new_opt["ef"] = new_ef
        if new_qef is not None:
            new_opt["qef"] = new_qef
        loss = all_reduce_sum(raw, mesh.data) / data_n
        if mesh.multi_pod:
            loss = all_reduce_sum(loss, mesh.pod) / pod_n
        return store, new_opt, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return step

