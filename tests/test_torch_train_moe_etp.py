"""Training an MoE model whose experts are both spread and sharded over
the ranks (ep = 2, etp = 2 at --mesh 1,4): four gloo ranks of the port
against JAX's jitted train step, as ``tests/test_torch_train_moe.py``
does at ep = 2.

The model is ``tests/_torch_etp_worker.py``'s (grok-1's smoke config with
2 experts, 4 kv heads and capacity factor 0.5; two GeGLU MoE blocks).
``_torch_etp_worker.py train`` runs ``tests/_torch_train_worker.py`` for
it in both packages, over two steps: JAX's step on four fake CPU devices
in a subprocess, then one rank process of the port a rank, whose mesh
has the plan's ep and etp subgroups. Each step starts from JAX's
weights. In the step the dispatch All2All and the combine run over the
ep subgroup forward and backward (the dispatch's backward the exact
all-to-all), the within-expert AllReduce over the etp subgroup (its
backward the exact sum), the TP sites over the whole model axis
(``tp_bwd`` for their backward under paper), the router's and the
norms' gradients summed over the model axis, and the expert weights'
stay each rank's own. ``_torch_train_worker.check`` holds every leaf to
its ``BOUNDS``, under bf16 and paper.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_etp_worker as etp  # noqa: E402
import _torch_train_worker as worker  # noqa: E402

MESH = "1,4"
POLICIES = ("bf16", "paper")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(ranks, {policy: JAX's}): JAX's steps and, beside them, the four
    ranks' (each waits for the JAX side's files when it needs them)."""
    out = str(tmp_path_factory.mktemp("train_moe_etp"))
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_torch_etp_worker.py")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={etp.TP}")
    names = ",".join(POLICIES)
    cmds = ([[sys.executable, script, "train", "jax", MESH, out, names,
              etp.ARCH]]
            + [[sys.executable, script, "train", str(r), MESH,
                os.path.join(out, "rendezvous"), out, names, etp.ARCH]
               for r in range(etp.TP)])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for c in cmds]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0].decode())
        finally:
            for q in procs if p.returncode else ():
                q.kill()
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return ([np.load(os.path.join(out, f"rank{r}.npz"))
             for r in range(etp.TP)],
            {n: np.load(os.path.join(out, f"jax_{n}.npz"))
             for n in POLICIES})


@pytest.mark.parametrize("name", POLICIES)
def test_etp_train_steps_match_jax(trained, name, monkeypatch):
    """Every rank's loss, grad norm, store change and AdamW moments at
    each of the two steps against JAX's, within
    ``_torch_train_worker.BOUNDS``."""
    monkeypatch.setattr(worker, "STEPS", etp.TRAIN_STEPS)
    ranks, want = trained
    worker.check(ranks, want[name], name)


def test_etp_ranks_agree(trained):
    """Every rank reports the same loss and grad norm, each finite, and
    paper's losses stay within 0.1 |bf16| + 0.1 of bf16's."""
    ranks, _ = trained
    for i in range(etp.TRAIN_STEPS):
        for name in POLICIES:
            for key in ("loss", "grad_norm"):
                vals = {float(r[f"{name}/{i}/{key}"]) for r in ranks}
                assert len(vals) == 1, (name, i, key, vals)
                assert np.isfinite(vals.pop())
        b = float(ranks[0][f"bf16/{i}/loss"])
        assert abs(float(ranks[0][f"paper/{i}/loss"]) - b) < \
            0.1 * abs(b) + 0.1
