"""Training glm4-9b's smoke config at (data, model) = (1, 4): its two kv
heads are replicated (tp > n_kv_heads), so every rank holds the whole
``wk`` and ``wv`` and uses the kv heads of its q heads; their gradients,
partial on each rank, are summed over the model axis with the other
TP-replicated leaves. Four gloo ranks of the port against JAX's jitted
train step on a (1, 4) mesh of fake CPU devices, as
``tests/test_torch_train.py`` does for llama3-8b, under bf16 and paper,
each step after the first from JAX's weights.

``_torch_train_worker.check`` states the bounds; the llama3-8b ones hold
here. Measured, the worst leaf of any step: bf16 loss 1.4e-7, grad norm
1.7e-7, the store's change 2.0e-4, ``m`` and ``v`` 1.6e-6; paper 1.3e-5,
7.4e-5, 0.087, 0.0044. A fault planted in a copy, ``wk`` and ``wv`` left
out of the model axis's sum, reads 1.02 (the store's change) and 0.90
(``m``) under bf16.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_train_worker as worker  # noqa: E402

ARCH = "glm4-9b"
MESH = "1,4"                        # DATA,MODEL
POLICIES = ("bf16", "paper")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return worker.run(str(tmp_path_factory.mktemp("train_tp4")), MESH,
                      POLICIES, arch=ARCH)


@pytest.mark.parametrize("name", POLICIES)
def test_replicated_kv_train_steps_match_jax(trained, name):
    ranks, want = trained
    worker.check(ranks, want[name], name)


def test_replicated_kv_ranks_agree(trained):
    """Every rank reports the same loss and grad norm."""
    ranks, _ = trained
    for name in POLICIES:
        for i in range(worker.STEPS):
            for k in ("loss", "grad_norm"):
                vals = {float(r[f"{name}/{i}/{k}"]) for r in ranks}
                assert len(vals) == 1, (name, i, k, vals)


@pytest.mark.parametrize("heads,kv,tp", [(4, 2, 4), (32, 2, 4), (32, 2, 8),
                                         (8, 2, 4), (40, 8, 16), (6, 2, 4),
                                         (40, 8, 2)])
def test_per_q_head_is_index_select(heads, kv, tp):
    """The kv head of each q head (``attention._per_q_head``: runs of
    broadcast slices) equals ``index_select`` by JAX's map (clamped
    global kv index, in replicate mode; local in shard mode) on every
    rank, forward and backward, for shard and replicate plans, padded q
    heads (40 heads at tp = 16) and ranks whose q heads start inside a
    kv head's (6 heads of 2 kv heads at tp = 4)."""
    import numpy as np
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models.config import ModelConfig
    from repro_torch.parallel.plan import make_plan
    cfg = ModelConfig(name="t", d_model=64, n_heads=heads, n_kv_heads=kv,
                      d_ff=64, vocab=64, head_dim=8, pattern=("dense",),
                      pattern_repeats=1)
    plan = make_plan(cfg, tp=tp)
    gen = torch.Generator().manual_seed(heads * 100 + tp)
    for rank in range(tp):
        q_per_kv = heads // kv
        gq = rank * plan.hq_loc + np.arange(plan.hq_loc)
        gkv = np.clip(gq // q_per_kv, 0, kv - 1)
        want_map = gkv if plan.kv_mode == "replicate" else np.clip(
            gkv - rank * plan.kv_loc, 0, plan.kv_loc - 1)
        kvmap = attn._kv_map(cfg, plan, rank)
        assert kvmap == want_map.tolist()
        t = torch.randn((2, 3, plan.kv_loc, 8), generator=gen,
                        requires_grad=True)
        ct = torch.randn((2, 3, plan.hq_loc, 8), generator=gen)
        got = attn._per_q_head(t, kvmap)
        (g_got,) = torch.autograd.grad(got, t, ct)
        want = torch.index_select(t, 2, torch.tensor(kvmap))
        (g_want,) = torch.autograd.grad(want, t, ct)
        assert torch.equal(got, want)
        assert torch.allclose(g_got, g_want, rtol=0, atol=1e-6)
