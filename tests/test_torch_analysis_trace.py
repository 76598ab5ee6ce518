"""The analyzer's trace lane held against the JAX package's.

The port records one smoke-size train step (``sites.record_train_sites``:
2 layers, seq 16, batch 2, one rank on the CPU) where the JAX package
lowers its jitted step; both logs are the ``(site, layer)`` pairs the
step resolves through the policy engine. The JAX side's three lowerings
(module fixture ``jax_traces``) are the only JAX compiles of the
analyzer's tests.
"""
import os
import sys

import pytest

from repro.analysis import sites as j_sites
from repro.configs import get_smoke_config as j_get_smoke
from repro_torch.analysis import sites as t_sites
from repro_torch.configs import get_smoke_config
from repro_torch.core.policy import paper_policy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_threads import one_torch_thread  # noqa: E402,F401


TRACE_ARCHS = ("qwen3-14b", "moonshot-v1-16b-a3b", "whisper-tiny")


@pytest.fixture(scope="module")
def jax_traces():
    """JAX's resolve log of its lowered smoke train step, per arch (the
    three lowerings of this file)."""
    from repro.core.policy import paper_policy as j_paper
    logs = {}
    real = j_sites.make_recording_policy
    try:
        for arch in TRACE_ARCHS:
            def rec(policy, log, arch=arch):
                logs[arch] = log
                return real(policy, log)
            j_sites.make_recording_policy = rec
            assert j_sites.trace_train_sites(arch, j_paper()) == []
    finally:
        j_sites.make_recording_policy = real
    return logs


@pytest.mark.parametrize("arch", TRACE_ARCHS)
def test_trace_log_matches_jax(arch, jax_traces):
    """The port's one recorded train step resolves what JAX's lowered
    step resolves, but for one difference (ROADMAP Queue C): JAX's
    forward runs ``policy_segments``, which resolves every layer site at
    every layer to split its scan, so its log holds ("a2a", i) for every
    block of a model with no moe block too. The port has no scan."""
    port = t_sites.record_train_sites(arch, paper_policy(), "cpu")
    jlog = jax_traces[arch]
    cfg = get_smoke_config(arch)
    assert cfg.n_layers == j_get_smoke(arch).n_layers
    segments = {("a2a", i) for i in range(cfg.n_layers)}
    assert port <= jlog
    if "moe" in cfg.layer_kinds:
        assert port == jlog
    else:
        assert jlog - port == segments
    assert t_sites.check_trace_log(cfg, port, arch) == []


def test_trace_catches_bypass(monkeypatch):
    """Every TP AllReduce planted to skip ``resolve`` (the exact sum,
    straight to the collective): the sites tp and tp_bwd never log, and
    SITE-TRACE fires."""
    from repro_torch.core.collectives import compressed_psum
    from repro_torch.core.comm_config import NO_COMPRESSION
    from repro_torch.models import attention, layers

    def bypass(x, policy, group=None, layer=None):
        return compressed_psum(x, NO_COMPRESSION, group, None)
    monkeypatch.setattr(layers, "tp_psum", bypass)
    monkeypatch.setattr(attention, "tp_psum", bypass)
    diags = t_sites.trace_train_sites("qwen3-14b", paper_policy(),
                                     device="cpu")
    assert [d.rule for d in diags] == ["SITE-TRACE", "SITE-TRACE"]
    assert "['tp', 'tp_bwd'] were never resolved" in diags[0].message


def test_recording_policy_survives_replace():
    log = set()
    rec = t_sites.make_recording_policy(paper_policy(), log)
    bound = rec.bind(4).map_sites(lambda c: c.with_backend("ref"))
    bound.resolve("tp", 2)
    bound.resolve("grad")
    assert type(bound) is type(rec) and log == {("tp", 2), ("grad", None)}
