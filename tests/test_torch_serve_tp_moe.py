"""Serving the moonshot smoke config at tp = 2, its experts spread over
the ranks (ep = 2): the port's gloo ranks against the JAX package on a
(1, 2) mesh, and the receive rows a peer world is sized with.

The JAX side is ``tests/test_torch_serve_tp.py``'s, run in a subprocess
for this config (``build_store`` at tp = 2 with a crc32 in place of the
salted ``hash``, float32, the zero-initialised output projections
filled from a seeded normal, so that every TP and dispatch site carries
data). Two gloo ranks (``tests/_torch_gloo_worker.py`` mode
``serve_moe``), started beside it, load their shards with
``load_jax_store(rank=r)`` once it has saved the store, and serve under paper/two_step, paper/fused (the emulated schedule of the
fused AllReduce and All2All around the gloo hops) and bf16. This is the
first whole MoE model at ep > 1 held against JAX.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_gloo_worker as worker  # noqa: E402
from test_torch_serve_tp import ROOT, TP, _run  # noqa: E402

ARCH = "moonshot-v1-16b-a3b"


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX reference and, beside it, two gloo ranks serving from its
    weights once it has saved them: (jax.npz, [rank0.npz, rank1.npz])."""
    out = tmp_path_factory.mktemp("serve_tp_moe")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    script = os.path.join(ROOT, "tests", "_torch_gloo_worker.py")
    _run([[sys.executable, os.path.join(ROOT, "tests",
                                        "test_torch_serve_tp.py"),
           "jax", str(out), ARCH]]
         + [[sys.executable, script, str(r), str(TP), str(out / "rdv"),
             str(out), "serve_moe"] for r in range(TP)], env)
    return (np.load(out / "jax.npz"),
            [np.load(out / f"rank{r}.npz") for r in range(TP)])


@pytest.mark.parametrize("run", list(worker.SERVE_RUNS))
def test_moe_prefill_matches_jax(served, run):
    """Each rank's prefill hidden states agree with JAX's within
    ``tests/test_torch_serve_tp.py``'s bounds: 2e-4 of their max
    magnitude without the codec (float32 summation order), one int8 step
    of the widest group (2 max|h| / 255) on every element under the
    paper policy. The greedy tokens over the vocabulary shards equal
    JAX's, and both ranks hold the same bits."""
    jax_out, ranks = served
    pol = run.split("/")[0]
    want = jax_out[f"{pol}/hidden"]
    hmax = np.abs(want).max()
    for r, res in enumerate(ranks):
        h = res[f"{run}/hidden"]
        np.testing.assert_array_equal(h.view(np.uint32),
                                      ranks[0][f"{run}/hidden"].view(
                                          np.uint32))
        diff = np.abs(h - want)
        bound = 2e-4 * hmax if pol == "bf16" else 2 * hmax / 255
        assert diff.max() <= bound, (r, diff.max(), bound)
        np.testing.assert_array_equal(res[f"{run}/token"],
                                      jax_out[f"{pol}/token"])


def test_moe_fused_equals_two_step(served):
    """On each rank the fused schedules (AllReduce and dispatch All2All)
    give two_step's bits: the prefill hidden states, every token of the
    served decode loop, and the routes dropped over capacity."""
    _, ranks = served
    for res in ranks:
        np.testing.assert_array_equal(
            res["paper/fused/hidden"].view(np.uint32),
            res["paper/two_step/hidden"].view(np.uint32))
        for key in ("generated", "dropped"):
            np.testing.assert_array_equal(res[f"paper/fused/{key}"],
                                          res[f"paper/two_step/{key}"])


@pytest.mark.parametrize("run", list(worker.SERVE_RUNS))
def test_moe_ranks_generate_alike(served, run):
    """serve's decode loop gives every rank the same tokens, each in the
    vocabulary."""
    _, ranks = served
    gen = ranks[0][f"{run}/generated"]
    assert gen.shape == (worker.SERVE_B, worker.SERVE_GEN)
    assert ((gen >= 0) & (gen < 512)).all()
    for res in ranks[1:]:
        np.testing.assert_array_equal(res[f"{run}/generated"], gen)


@pytest.mark.parametrize("policy", ["paper", "aggressive"])
def test_site_row_bytes_cover_the_dispatch(policy):
    """A peer world's receive rows hold moonshot's prefill dispatch at
    tp = 2 (batch 4 x prompt 128): e_loc 32 x capacity 64 = 2048 rows of
    wire_bytes(2048) a peer under the policy's dispatch config (the
    aggressive policy slices the tokens by ep and sends fewer), and its
    largest TP site's chunk; qwen3-14b's rows stay the f32 bytes of its
    largest TP site's chunk."""
    from repro_torch.configs import get_config
    from repro_torch.core import policy as tpolicy
    from repro_torch.launch import mesh
    from repro_torch.models.moe import capacity
    from repro_torch.parallel.plan import make_plan
    cfg = get_config(ARCH)
    plan = make_plan(cfg, tp=2)
    pol = {"paper": tpolicy.paper_policy,
           "aggressive": tpolicy.aggressive_policy}[policy]()
    rows = mesh.site_row_bytes(cfg, plan, 4, 128).model
    m = plan.moe.e_loc * capacity(4 * 128, cfg)
    assert (plan.moe.ep, m) == (2, 2048)
    a2a, tp_cfg = pol.resolve("a2a", 1), pol.resolve("tp", 1)
    assert rows >= m * a2a.wire_bytes(2048) == 2048 * a2a.wire_bytes(2048)
    assert rows >= tp_cfg.wire_bytes(4 * 128 * 2048 // 2)
    assert rows == 2 * m * 2048 > 2 * 1024 * 1024
    qwen = get_config("qwen3-14b")
    for tp in (1, 2, 4, 8):
        n = 4 * 128 * qwen.d_model
        assert mesh.site_row_bytes(qwen, make_plan(qwen, tp=tp), 4, 128) \
            == (4 * -(-n // (tp * 128)) * 128, 0, 0)
    assert mesh.site_row_bytes(qwen, make_plan(qwen, tp=2), 4, 128) == \
        (5242880, 0, 0)


#: (arch, smoke config?, tp) of each world-rows case: grok-1 at tp = 16
#: (ep 8, etp 2: all three worlds), llama4-maverick at tp = 16 (ep 16:
#: the dispatch crosses the model world) and grok-1's smoke config at
#: tp = 8 (ep 4, etp 2)
WORLD_CASES = [("grok-1-314b", False, 16),
               ("llama4-maverick-400b-a17b", False, 16),
               ("grok-1-314b", True, 8)]


@pytest.mark.parametrize("arch,smoke,tp", WORLD_CASES)
@pytest.mark.parametrize("batch,seq", [(4, 128), (8, 512)])
@pytest.mark.parametrize("policy", ["paper", "aggressive"])
def test_site_row_bytes_cover_each_world(arch, smoke, tp, batch, seq,
                                         policy):
    """Each peer world's receive rows hold the largest wire that crosses
    it, for a served prefill (batch 4 x prompt 128) and a training step's
    local tokens (8 x 512): the model world a TP site's chunk forward and
    backward (``tp_bwd``), and where the dispatch spans the whole axis
    (etp = 1) the ``e_loc * capacity`` rows a peer of the dispatch; with
    ep and etp both above 1, the ep world the dispatch and the etp world
    the within-expert AllReduce's chunk of ``e_loc * ep * capacity *
    d_model`` partial sums, each under the policy's configs (aggressive
    slices the tokens by ep). No world is made where no subaxis is."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import policy as tpolicy
    from repro_torch.launch import mesh
    from repro_torch.models.moe import capacity
    from repro_torch.parallel.plan import make_plan
    cfg = (get_smoke_config if smoke else get_config)(arch)
    plan = make_plan(cfg, tp=tp)
    mp = plan.moe
    pol = {"paper": tpolicy.paper_policy,
           "aggressive": tpolicy.aggressive_policy}[policy]()
    rows = mesh.site_row_bytes(cfg, plan, batch, seq)
    t, d = batch * seq, cfg.d_model

    def chunk(n, ranks, c):
        return c.wire_bytes(-(-n // (ranks * c.group)) * c.group)

    tp_wires = [chunk(t * d, tp, c) for c in (pol.resolve("tp", 1),
                                               pol.resolve("tp_bwd", 1))
                if c is not None]
    cap = capacity(-(-t // mp.ep) if pol.ep_slice else t, cfg)
    a2a = pol.resolve("a2a", 1)
    dispatch = mp.e_loc * cap * a2a.wire_bytes(d)
    psum = chunk(mp.e_loc * mp.ep * cap * d, mp.etp, pol.resolve("tp", 1))
    assert rows.model >= max(tp_wires)
    if mp.etp == 1:
        assert rows.model >= dispatch and rows.ep == rows.etp == 0
    else:
        assert rows.ep >= dispatch and rows.etp >= psum
    if (arch, smoke, tp, batch, policy) == ("grok-1-314b", False, 16, 4,
                                            "paper"):
        assert (mp.ep, mp.etp, mp.e_loc, cap) == (8, 2, 1, 160)
        assert rows == (4 * 512 * 6144 // 16, 2 * 160 * 6144,
                        4 * 8 * 160 * 6144 // 2)
