"""Training llama3-8b's smoke config at (pod, data, model) = (1, 2, 1)
(no pod axis, fsdp = 2): two gloo ranks of the port against the JAX
package, as ``tests/test_torch_train.py`` does at (2, 2, 2), under bf16,
paper, depth and aggressive (the qag weight gather at int4 with Eq.-1
scales, the explicit quantized gradient reduce-scatter at int8, tp_bwd).
Also the launcher at ``--mesh 2,1`` on the CPU.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_train_worker as worker  # noqa: E402

MESH = "2,1"                        # DATA,MODEL
POLICIES = ("bf16", "paper", "depth", "aggressive")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return worker.run(str(tmp_path_factory.mktemp("train121")), MESH,
                      POLICIES)


@pytest.mark.parametrize("name", POLICIES)
def test_fsdp_train_steps_match_jax(trained, name):
    ranks, want = trained
    worker.check(ranks, want[name], name)


def test_fsdp_ranks_agree(trained):
    """Both data ranks report the same loss and grad norm, and the
    quantized runs' losses stay within 0.1 |bf16| + 0.1 of bf16's."""
    ranks, _ = trained
    for name in POLICIES:
        for i in range(worker.STEPS):
            vals = {float(r[f"{name}/{i}/loss"]) for r in ranks}
            assert len(vals) == 1, (name, i, vals)
            b = float(ranks[0][f"bf16/{i}/loss"])
            assert abs(vals.pop() - b) < 0.1 * abs(b) + 0.1, (name, i)


def test_train_cli_mesh_cpu():
    """``--mesh 2,1 --device cpu`` trains the smoke config in two rank
    processes and ends with the JAX launcher's JSON line; without
    ``--device cpu`` and without a GPU the launcher raises; ``--check``
    raises NotImplementedError naming its ROADMAP item
    (``--framed-bridge`` trains: tests/test_torch_frame.py); an MoE arch
    trains (its dispatch's backward is ported), its losses finite."""
    from repro_torch.launch import train as ttrain
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3-8b", "--smoke", "--device", "cpu", "--steps", "3",
         "--mesh", "2,1", "--seq", "16", "--batch", "4", "--log-every", "1",
         "--policy", "aggressive"], env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res) == {"first_loss", "last_loss"}
    assert np.isfinite(res["first_loss"]) and np.isfinite(res["last_loss"])
    smoke = ["--arch", "llama3-8b", "--smoke", "--steps", "1"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.main(smoke)
    with pytest.raises(NotImplementedError, match="item 7"):
        ttrain.main(smoke + ["--device", "cpu", "--check"])
    res = ttrain.main(["--arch", "moonshot-v1-16b-a3b", "--smoke",
                       "--device", "cpu", "--steps", "2", "--seq", "16",
                       "--batch", "4", "--log-every", "1"])
    assert len(res["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in res["history"])
