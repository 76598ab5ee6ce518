"""Training recurrentgemma-2b (RG-LRU + sliding-window attention) and
xlstm-125m (mLSTM / sLSTM) smoke configs: gloo ranks of the port against
JAX's jitted train step, as ``tests/test_torch_train.py`` does for
llama3-8b, and each recurrent mixer's gradient against ``jax.grad``.

``tests/_torch_train_worker.py`` runs JAX's step on a (1, 2) mesh of
fake CPU devices beside two rank processes of the port (tp = 2), from
the same float32 store, three steps of the same batches, each step after
the first from JAX's weights, under bf16 and paper. recurrentgemma runs
80 tokens a row (``SEQ``), past its smoke window of 64, so that the
local block's windowed mask is differentiated; RG-LRU's associative scan
and the cells' loops over the sequence run under
``torch.utils.checkpoint`` and are replayed in the backward.

``_torch_train_worker.check`` states the bounds; the llama3-8b ones hold
here, and no per-arch bound is needed. Measured, the worst leaf of any
step and rank: recurrentgemma bf16 loss 1.5e-7, the store's change
6.5e-4, ``m`` and ``v`` 6.5e-6; paper loss 7.7e-5, grad norm 1.9e-4, the
store's change 0.26, ``m`` and ``v`` 0.016. xlstm bf16 loss 7.5e-8, grad
norm 1.6e-7, 2.7e-4, 1.6e-6; paper 4.7e-6, 1.6e-5, 0.027, 9.8e-4; its
sLSTM input-gate bias ``sl_bi`` has a gradient of rounding noise on both
sides (``ZERO_GRAD_LEAVES``;
:func:`test_slstm_input_gate_bias_gradient_is_zero`), its ``m`` at most
6.9e-10 of the whole ``m`` against the bound of 1e-5. Faults planted in
a copy: the local block's window dropped reads loss 1.5e-4 and ``m``
0.16 under bf16. The stabiliser ``m`` detached in either cell reads as
the sound port does (loss 7.3e-8, ``m`` 1.2e-6): where neither cell's
floor (``exp(-m)``, ``n >= 1e-6``) binds, the output does not depend on
the stabiliser, so its gradient is zero either way.
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
from repro.models import recurrent as jrec  # noqa: E402
from repro.parallel.plan import make_plan as jmake_plan  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.policy import BF16_POLICY  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402
from repro_torch.parallel.plan import make_plan  # noqa: E402

MESH = "1,2"                        # DATA,MODEL
POLICIES = ("bf16", "paper")
#: arch -> tokens a row; recurrentgemma's past its smoke window of 64
SEQ = {"recurrentgemma-2b": 80, "xlstm-125m": worker.SEQ}
CASES = [(a, p) for a in SEQ for p in POLICIES]
#: the mixers' gradient checks: kind -> (arch, JAX's mixer, the port's,
#: the port's parameter specs)
MIXERS = {"rec": ("recurrentgemma-2b", jrec.rglru_apply, trec.rglru_apply,
                  trec.rglru_specs),
          "mlstm": ("xlstm-125m", jrec.mlstm_apply, trec.mlstm_apply,
                    trec.mlstm_specs),
          "slstm": ("xlstm-125m", jrec.slstm_apply, trec.slstm_apply,
                    trec.slstm_specs)}
MIX_B, MIX_S = 2, 24


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """arch -> (ranks, JAX's), each arch's runs made once a module."""
    cache = {}

    def get(arch):
        if arch not in cache:
            out = tmp_path_factory.mktemp("train_rec")
            cache[arch] = worker.run(str(out), MESH, POLICIES, arch=arch,
                                     seq=SEQ[arch])
        return cache[arch]
    return get


@pytest.mark.parametrize("arch,name", CASES)
def test_recurrent_train_steps_match_jax(trained, arch, name):
    ranks, want = trained(arch)
    worker.check(ranks, want[name], name, arch)


@pytest.mark.parametrize("arch", list(SEQ))
def test_recurrent_ranks_agree(trained, arch):
    """Every rank reports the same loss and grad norm, and paper's losses
    stay within 0.1 |bf16| + 0.1 of bf16's."""
    ranks, _ = trained(arch)
    for name in POLICIES:
        for i in range(worker.STEPS):
            vals = {float(r[f"{name}/{i}/loss"]) for r in ranks}
            assert len(vals) == 1, (arch, name, i, vals)
            b = float(ranks[0][f"bf16/{i}/loss"])
            assert abs(vals.pop() - b) < 0.1 * abs(b) + 0.1, (arch, name, i)


def _mixer_grads(kind: str, seed: int = 0):
    """The mixer ``kind`` of its smoke config at tp = 1, float32, no
    codec, on seeded weights and input: the gradient of ``sum(y * ct)``
    with respect to the input and every parameter, JAX's (``jax.grad``
    of its mixer under a jitted shard_map) and the port's (autograd) ->
    (names, JAX's list, the port's list), the input's first."""
    arch, jfn, tfn, specs = MIXERS[kind]
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jplan, plan = jmake_plan(jcfg, tp=1, fsdp=1), make_plan(cfg, tp=1)
    sp = specs(cfg, plan)
    names = sorted(sp)
    rng = np.random.default_rng(seed)
    p = {n: (rng.standard_normal(sp[n].shape)
             / np.sqrt(sp[n].shape[-2] if len(sp[n].shape) > 1 else 1)
             ).astype(np.float32) for n in names}
    x = rng.standard_normal((MIX_B, MIX_S, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(x, *ws):
        y = jfn(dict(zip(names, ws)), x, jcfg, jplan, JBF16, layer=0)[0]
        return jnp.sum(y * ct)

    n = 1 + len(names)
    grad = jax.jit(compat.shard_map(
        jax.grad(jloss, argnums=tuple(range(n))), mesh=make_test_mesh(1, 1),
        in_specs=(P(),) * n, out_specs=(P(),) * n, check_vma=False))
    want = [np.asarray(g) for g in grad(x, *(p[k] for k in names))]
    tx = torch.from_numpy(x).requires_grad_()
    tp = {k: torch.from_numpy(p[k]).requires_grad_() for k in names}
    y = tfn(tp, tx, cfg, plan, BF16_POLICY.bind(1), layer=0)
    (y * torch.from_numpy(ct)).sum().backward()
    got = [tx.grad.numpy()] + [tp[k].grad.numpy() for k in names]
    return ["x"] + names, want, got


@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_gradient_matches_jax(kind):
    """``rglru_apply`` (the associative scan, ``sqrt(max(1 - a^2,
    1e-9))``, softplus and the sigmoid gates), ``mlstm_apply`` and
    ``slstm_apply`` (the loops, the stabiliser ``m`` not detached, as
    JAX's) under autograd against ``jax.grad`` of JAX's, float32, S =
    24: the input's and every parameter's gradient within 1e-5 of its L2
    norm (float32 order; measured at most 1.3e-6), but the sLSTM
    input-gate bias's, which is zero in exact arithmetic
    (:func:`test_slstm_input_gate_bias_gradient_is_zero`)."""
    names, want, got = _mixer_grads(kind)
    for n, w, g in zip(names, want, got):
        if kind == "slstm" and n == "sl_bi":
            continue
        assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w), n


def test_slstm_input_gate_bias_gradient_is_zero():
    """A constant added to every input gate of an sLSTM head scales every
    weight of the normaliser ``c / n`` alike, so the output does not move
    and the input-gate bias's gradient is zero in exact arithmetic: both
    packages' are float32 rounding noise, below 1e-7 of the input-gate
    weights' (measured 3.2e-7 against 96 in JAX, 2.9e-7 in the port), so
    the training checks hold its ``m`` by its size
    (``_torch_train_worker.ZERO_GRAD_LEAVES``)."""
    names, want, got = _mixer_grads("slstm")
    i, w = names.index("sl_bi"), names.index("sl_wi")
    for grads in (want, got):
        assert np.linalg.norm(grads[i]) <= 1e-7 * np.linalg.norm(grads[w])
