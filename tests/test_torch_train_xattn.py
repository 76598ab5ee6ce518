"""Training whisper-tiny (encoder-decoder) and llama-3.2-vision-11b
(image cross-attention) smoke configs: gloo ranks of the port against
JAX's jitted train step, as ``tests/test_torch_train.py`` does for
llama3-8b, on the stream's stub frontend embeddings (``enc_embeds``,
float32 on both sides), and the cross-attention's gradient against
``jax.grad``.

``tests/_torch_train_worker.py`` runs JAX's step on a mesh of fake CPU
devices beside the port's rank processes, from the same float32 store,
three steps of the same batches, each step after the first from JAX's
weights:

* whisper-tiny at (data, model) = (2, 2): the embeddings split over the
  data axis with the tokens, the encoder's blocks (their sites at
  ``layer=None``) gathered and checkpointed one by one and replayed in
  the backward, the cross-attention's gradient flowing through the
  encoder's output into the encoder; under bf16, paper and
  aggressive_ef (fsdp = 2: the ``encoder`` and ``encoder_extra`` groups
  through the qag gather and the quantized gradient reduce-scatter with
  its EF residual ``qef``);
* llama-3.2-vision-11b at (1, 2): the xattn block's keys and values from
  the image embeddings, under bf16 and paper.

``_torch_train_worker.check`` states the bounds; the llama3-8b ones hold
here, and no per-arch bound is needed. Measured, the worst leaf of any
step and rank: whisper bf16 loss 7.4e-8, the store's change 2.9e-4, ``m``
and ``v`` 1.9e-6; paper loss 4.1e-5, grad norm 2.0e-4, the store's
change 0.12, ``m`` and ``v`` 0.0058; aggressive_ef 8.2e-5, 4.0e-4, 0.17,
0.021, ``qef``'s sum rule 7.1e-9 and its norms 0.52-1.98 of JAX's.
llama bf16 7.0e-8, 8.9e-8, 4.3e-4, 1.4e-6; paper 1.3e-5, 2.7e-5, 0.12,
0.0033. whisper's key biases (``bk``, ``xbk``) have a gradient of
rounding noise on both sides (``ZERO_GRAD_LEAVES``;
:func:`test_cross_attention_gradient_matches_jax`), their ``m`` at most
6.4e-10 of the whole ``m`` against the bound of 1e-5. A fault planted in
a copy, the gradient into the encoder's output halved (its forward
kept), reads grad norm 0.12, ``m`` 0.43 and ``v`` 0.67 under bf16.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_train_worker as worker  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.policy import BF16_POLICY as JBF16  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.parallel.plan import make_plan as jmake_plan  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.policy import BF16_POLICY  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.parallel.plan import make_plan  # noqa: E402

#: arch -> (mesh DATA,MODEL, the policies trained there)
RUNS = {"whisper-tiny": ("2,2", ("bf16", "paper", "aggressive_ef")),
        "llama-3.2-vision-11b": ("1,2", ("bf16", "paper"))}
CASES = [(a, p) for a, (_, pols) in RUNS.items() for p in pols]
XB, XS, XENC = 2, 12, 20


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """arch -> (ranks, JAX's), each arch's runs made once a module."""
    cache = {}

    def get(arch):
        if arch not in cache:
            mesh, pols = RUNS[arch]
            out = tmp_path_factory.mktemp("train_xattn")
            cache[arch] = worker.run(str(out), mesh, pols, arch=arch)
        return cache[arch]
    return get


@pytest.mark.parametrize("arch,name", CASES)
def test_cross_train_steps_match_jax(trained, arch, name):
    ranks, want = trained(arch)
    worker.check(ranks, want[name], name, arch)


@pytest.mark.parametrize("arch", list(RUNS))
def test_cross_ranks_agree(trained, arch):
    """Every rank reports the same loss and grad norm, and the quantized
    runs' losses stay within 0.1 |bf16| + 0.1 of bf16's."""
    ranks, _ = trained(arch)
    for name in RUNS[arch][1]:
        for i in range(worker.STEPS):
            vals = {float(r[f"{name}/{i}/loss"]) for r in ranks}
            assert len(vals) == 1, (arch, name, i, vals)
            b = float(ranks[0][f"bf16/{i}/loss"])
            assert abs(vals.pop() - b) < 0.1 * abs(b) + 0.1, (arch, name, i)


@pytest.mark.parametrize("arch", list(RUNS))
def test_cross_attention_gradient_matches_jax(arch):
    """``cross_attention`` of the smoke config at tp = 1, float32, no
    codec, on seeded weights (whisper's biases too), decoder states (2,
    12) and encoder states (2, 20) under autograd against ``jax.grad`` of
    JAX's: the gradient into the decoder's and the encoder's states and
    into every ``x``-prefixed weight within 1e-5 of its L2 norm (float32
    order), but the key bias ``xbk``'s: the softmax over the keys is
    invariant to the ``q . xbk`` it adds to every score, so that gradient
    is zero in exact arithmetic, and both packages' stay below 1e-6 of
    the query bias's (``_torch_train_worker.ZERO_GRAD_LEAVES``)."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jplan, plan = jmake_plan(jcfg, tp=1, fsdp=1), make_plan(cfg, tp=1)
    sp = tattn.attn_specs(cfg, plan, prefix="x")
    names = sorted(sp)
    rng = np.random.default_rng(3)
    p = {n: (rng.standard_normal(sp[n].shape)
             / np.sqrt(sp[n].shape[-2] if len(sp[n].shape) > 1 else 1)
             ).astype(np.float32) for n in names}
    x = rng.standard_normal((XB, XS, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((XB, XENC, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(x, enc, *ws):
        y = jattn.cross_attention(dict(zip(names, ws)), x, enc, jcfg, jplan,
                                  JBF16, layer=0)
        return jnp.sum(y * ct)

    n = 2 + len(names)
    grad = jax.jit(compat.shard_map(
        jax.grad(jloss, argnums=tuple(range(n))), mesh=make_test_mesh(1, 1),
        in_specs=(P(),) * n, out_specs=(P(),) * n, check_vma=False))
    want = [np.asarray(g) for g in grad(x, enc, *(p[k] for k in names))]
    tx, tenc = (torch.from_numpy(a).requires_grad_() for a in (x, enc))
    tp = {k: torch.from_numpy(p[k]).requires_grad_() for k in names}
    y = tattn.cross_attention(tp, tx, tenc, cfg, plan, BF16_POLICY.bind(1),
                              layer=0)
    (y * torch.from_numpy(ct)).sum().backward()
    got = [tx.grad.numpy(), tenc.grad.numpy()] + [tp[k].grad.numpy()
                                                  for k in names]
    for k, w, g in zip(["x", "enc"] + names, want, got):
        if k == "xbk":
            ref = np.linalg.norm(want[2 + names.index("xbq")])
            assert max(np.linalg.norm(w), np.linalg.norm(g)) <= 1e-6 * ref
            continue
        assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w), k
