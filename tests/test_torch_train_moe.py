"""Training moonshot-v1-16b-a3b's smoke config (a dense block, then an MoE
block of 4 experts, top-2): gloo ranks of the port against the JAX
package, as ``tests/test_torch_train.py`` does for llama3-8b.

``tests/_torch_train_worker.py`` runs JAX's jitted train step on a mesh
of fake CPU devices in a subprocess, then one rank process of the port a
rank on gloo, from the same float32 store, over three steps of the same
batches, each step after the first from JAX's weights:

* at (data, model) = (1, 2): ep = 2, each rank holding two experts, the
  dispatch All2All inside the step forward and backward, under bf16,
  paper (the dispatch at int4 g32, the TP sites at int8) and aggressive
  (``ep_slice``: each rank dispatches half the tokens, the outputs
  gathered and the aux loss averaged over the ranks);
* at (2, 1): fsdp = 2, the expert leaves gathered over the data axis
  with the others, under bf16 and aggressive (the qag gather at int4,
  the quantized gradient reduce-scatter at int8).

The load-balance loss enters the loss at weight 0.01 on both sides.
``_torch_train_worker.check`` states the bounds; the llama3-8b ones hold
here. Measured, the worst leaf of any step: bf16 loss 7e-8, the store's
change 2.1e-4, ``m`` and ``v`` 2.2e-6; paper 1.3e-4, 0.18, 0.033;
aggressive 1.5e-7, 0.071, 0.0073. Faults planted in a copy read far
above: the dispatch's backward dropped, ``m`` 0.93 (bf16); the combine's
backward the identity, ``m`` 1.11; ``ep_slice``'s gather's backward this
rank's row unreduced, ``m`` 0.76 (aggressive); the aux loss left out,
loss 1.6e-3 and the store's change 0.14 (bf16).
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_train_worker as worker  # noqa: E402

ARCH = "moonshot-v1-16b-a3b"
#: mesh DATA,MODEL -> the policies trained there
MESHES = {"1,2": ("bf16", "paper", "aggressive"),
          "2,1": ("bf16", "aggressive")}
#: (mesh, policy) of every run
CASES = [(m, p) for m, pols in MESHES.items() for p in pols]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """mesh -> (ranks, JAX's), each mesh's runs made once a module."""
    cache = {}

    def get(mesh):
        if mesh not in cache:
            out = tmp_path_factory.mktemp("train_moe")
            cache[mesh] = worker.run(str(out), mesh, MESHES[mesh],
                                     arch=ARCH)
        return cache[mesh]
    return get


@pytest.mark.parametrize("mesh,name", CASES)
def test_moe_train_steps_match_jax(trained, mesh, name):
    ranks, want = trained(mesh)
    worker.check(ranks, want[name], name)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_moe_ranks_agree(trained, mesh):
    """Every rank reports the same loss and grad norm, and the quantized
    runs' losses stay within 0.1 |bf16| + 0.1 of bf16's."""
    ranks, _ = trained(mesh)
    for name in MESHES[mesh]:
        for i in range(worker.STEPS):
            vals = {float(r[f"{name}/{i}/loss"]) for r in ranks}
            assert len(vals) == 1, (mesh, name, i, vals)
            b = float(ranks[0][f"bf16/{i}/loss"])
            assert abs(vals.pop() - b) < 0.1 * abs(b) + 0.1, (mesh, name, i)


@pytest.mark.parametrize("policy", ["paper", "aggressive"])
def test_site_row_bytes_cover_the_training_step(policy):
    """The model axis's peer world for moonshot's training step at
    --mesh 1,2 (b_loc 8 x seq 512 tokens a rank) holds its dispatch:
    e_loc 32 x capacity(4096) = 480 rows a peer of wire_bytes(2048) under
    the policy's dispatch config (aggressive's ep_slice sends the
    capacity of half the tokens), and its TP sites' chunks forward and
    backward (``tp_bwd``); the dispatch's backward is exact, over the
    process group."""
    from repro_torch.configs import get_config
    from repro_torch.core import policy as tpolicy
    from repro_torch.launch import mesh
    from repro_torch.models.moe import capacity
    from repro_torch.parallel.plan import make_plan
    cfg = get_config(ARCH)
    plan = make_plan(cfg, tp=2)
    pol = {"paper": tpolicy.paper_policy,
           "aggressive": tpolicy.aggressive_policy}[policy]()
    rows = mesh.site_row_bytes(cfg, plan, 8, 512).model
    tokens = 8 * 512 // (2 if pol.ep_slice else 1)
    m = plan.moe.e_loc * capacity(tokens, cfg)
    assert capacity(8 * 512, cfg) == 480
    assert rows >= m * pol.resolve("a2a", 1).wire_bytes(2048)
    for site in ("tp", "tp_bwd"):
        c = pol.resolve(site, 1)
        if c is not None:
            assert rows >= c.wire_bytes(8 * 512 * 2048 // 2)
    assert rows == 2 * 32 * 480 * 2048
