"""Training llama3-8b's smoke config at (pod, data, model) = (2, 2, 2):
eight gloo ranks of the port against the JAX package.

``tests/_torch_train_worker.py`` runs JAX's jitted train step on a
(pod 2, data 2, model 2) mesh of eight fake CPU devices in a subprocess,
then eight rank processes of the port on gloo, from the same float32
store, over three steps of the same batches, under bf16, paper (the TP
sites and the cross-pod grad site at int8), depth (TP by depth, the grad
site at 2 bits with error feedback) and aggressive with error feedback
(the qag and qgrad_rs sites at fsdp = 2, tp_bwd, and the grad site's
hier_pp EF); after each step every rank holds its loss, grad norm, store,
``m``, ``v`` and EF residuals against JAX's (``check`` states the
bounds).
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_train_worker as worker  # noqa: E402

MESH = "2,2,2"                      # DATA,MODEL,POD
POLICIES = ("bf16", "paper", "depth", "aggressive_ef")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return worker.run(str(tmp_path_factory.mktemp("train222")), MESH,
                      POLICIES)


@pytest.mark.parametrize("name", POLICIES)
def test_train_steps_match_jax(trained, name):
    ranks, want = trained
    worker.check(ranks, want[name], name)


def test_paper_loss_near_bf16(trained):
    """The quantized runs' losses stay within 0.1 |bf16| + 0.1 of the
    unquantized run's, as the JAX package's multi-device check holds."""
    ranks, _ = trained
    for name in POLICIES[1:]:
        for i in range(worker.STEPS):
            a = float(ranks[0][f"{name}/{i}/loss"])
            b = float(ranks[0][f"bf16/{i}/loss"])
            assert abs(a - b) < 0.1 * abs(b) + 0.1, (name, i, a, b)


def test_ranks_agree(trained):
    """Every rank reports the same loss and grad norm."""
    ranks, _ = trained
    for name in POLICIES:
        for i in range(worker.STEPS):
            for k in ("loss", "grad_norm"):
                vals = {float(r[f"{name}/{i}/{k}"]) for r in ranks}
                assert len(vals) == 1, (name, i, k, vals)
