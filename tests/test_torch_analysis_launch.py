"""The analyzer at launch: the fused-request guard, the card's budget
table, the CLI and both launchers' ``--check``.

The guard's card checks run with the H100's limits given as arguments
(``smem.H100``), so no GPU is needed; off the card (``card=False``) the
same requests pass, as the JAX package's ``test_fused_guard_quiet_off_tpu``
holds for its own guard.
"""
import json
import os
import sys

import pytest

from repro_torch.analysis import commcheck as tcc
from repro_torch.analysis import smem
from repro_torch.analysis.report import CommCheckError
from repro_torch.configs import get_config
from repro_torch.core.comm_config import CommConfig
from repro_torch.core.policy import CommPolicy, paper_policy, with_scheme
from repro_torch.parallel.plan import make_plan

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_threads import one_torch_thread  # noqa: E402,F401


def _planted():
    """The three fused requests the hand kernels cannot serve."""
    qwen = get_config("qwen3-14b")
    g16 = CommPolicy(tp=CommConfig(bits=8, group=16, scheme="fused"))
    fused = with_scheme(paper_policy(), "fused")
    return {
        "group16_tp2": (qwen, make_plan(qwen, tp=2), g16,
                        {"data": 1, "model": 2},
                        dict(global_batch=4, seq=16, mode="prefill")),
        "tp17": (qwen, make_plan(qwen, tp=17), fused,
                 {"data": 1, "model": 17},
                 dict(global_batch=4, seq=16, mode="prefill")),
        "qwen3_train_4k_16_ranks": (
            qwen, make_plan(qwen, tp=16), fused, {"data": 1, "model": 16},
            dict(global_batch=256, seq=4096, n_micro=2, mode="train")),
    }


@pytest.mark.parametrize("case", sorted(_planted()))
def test_guard_refuses_on_card_passes_off_card(case):
    cfg, plan, pol, mesh, kw = _planted()[case]
    with pytest.raises(CommCheckError) as ei:
        tcc.check_fused_request(cfg, plan, pol, mesh, card=True,
                                limits=smem.H100, context=case, **kw)
    fired = ei.value.report.rules_fired()
    assert "SITE-FUSED-MESH" in fired
    want = {"group16_tp2": "CARD-CODEC", "tp17": "SITE-FUSED-MESH",
            "qwen3_train_4k_16_ranks": "CARD-PEERMEM"}[case]
    assert want in fired
    # off the card the fused scheme runs its plain version
    tcc.check_fused_request(cfg, plan, pol, mesh, card=False, **kw)


def test_guard_quiet_for_chip_smoke_launches():
    """Every fused launch chip_smoke.py makes passes the guard at the
    H100's limits."""
    import chip_smoke
    launches = chip_smoke.fused_launches()
    assert len(launches) >= 10
    for arch, mesh, policy, kw in launches:
        cfg = get_config(arch)
        plan = make_plan(cfg, tp=mesh["model"], fsdp=mesh.get("data", 1))
        pol = with_scheme(tcc.shipped_policies()[policy], "fused")
        tcc.check_fused_request(cfg, plan, pol, mesh, card=True,
                                limits=smem.H100,
                                context=f"{arch} {mesh}", **kw)


def test_guard_skips_unfused_and_budget_is_clean():
    cfg, plan, _, mesh, kw = _planted()["qwen3_train_4k_16_ranks"]
    tcc.check_fused_request(cfg, plan, paper_policy(), mesh, card=True,
                            limits=smem.H100, **kw)
    diags, n = smem.check_budget(smem.H100)
    assert diags == [] and n == len(smem.INSTANCES) == 99
    rep = tcc.all_report(card=True, limits=smem.H100)
    assert rep.ok and rep.checked > tcc.core_report().checked


def test_instance_table_matches_modes():
    """fc_ar's and fc_a2a's instantiations are AR_MODES and A2A_MODES, in
    order; every source's table is what its fc_<source>_attrs reports
    (nine modes: the encode, 3 decodes and 2 decode+reduces of each)."""
    from repro_torch.kernels.rdma import A2A_MODES, AR_MODES
    by = {s: [k for k in smem.INSTANCES if k.source == s]
          for s in smem.SOURCES}
    assert [k.mode for k in by["allreduce.cu"]] == list(AR_MODES)
    assert [k.mode for k in by["rdma.cu"]] == list(A2A_MODES)
    assert [len(by[s]) for s in smem.SOURCES] == [54, 15, 9, 18, 3]


def test_cli_exits_zero(capsys):
    for argv in ([], ["--selftest"], ["--rules"],
                 ["--arch", "qwen3-14b", "--policy", "paper", "--mesh",
                  "2,4"], ["--card"]):
        assert tcc.main(argv) == 0, argv
        assert capsys.readouterr().out, argv


def test_cli_trace_runs_on_the_card_unless_cpu(monkeypatch, capsys):
    """--trace's train step runs on the card unless --device cpu is
    given: with no card it raises, as the launchers do."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--arch", "qwen3-14b", "--mesh", "1,2", "--trace"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcc.main(argv)
    assert tcc.main(argv + ["--device", "cpu"]) == 0
    assert "PASS" in capsys.readouterr().out


def _hier_policy_file(tmp_path):
    path = tmp_path / "hier_a2a.json"
    path.write_text(json.dumps({"sites": {"a2a": {
        "schedule": "uniform", "config": {"bits": 4, "group": 32,
                                          "scheme": "hierarchical"}}}}))
    return str(path)


def test_check_refuses_before_any_rank(tmp_path, monkeypatch, capsys):
    """Both launchers with a policy file whose dispatch is hierarchical
    (SITE-SCHEME) at --mesh 1,2: exit 2, no rank process started."""
    from repro_torch.launch import mesh, serve, train
    started = []
    monkeypatch.setattr(mesh, "run_ranks",
                        lambda *a, **k: started.append(a))
    for main in (serve.main, train.main):
        with pytest.raises(SystemExit) as ei:
            main(["--arch", "moonshot-v1-16b-a3b", "--smoke", "--device",
                  "cpu", "--mesh", "1,2", "--check", "--policy-file",
                  _hier_policy_file(tmp_path)])
        assert ei.value.code == 2 and not started
        assert "SITE-SCHEME" in capsys.readouterr().out


def test_check_keeps_tokens_and_losses():
    """The paper policy: the same served tokens and trained losses with
    --check as without."""
    from repro_torch.launch import serve, train
    argv = ["--arch", "qwen3-14b", "--smoke", "--device", "cpu", "--batch",
            "2", "--prompt-len", "8", "--gen", "3"]
    a, b = serve.main(argv), serve.main(argv + ["--check"])
    assert (a["generated"] == b["generated"]).all()
    argv = ["--arch", "qwen3-14b", "--smoke", "--device", "cpu", "--steps",
            "2", "--seq", "16", "--batch", "2"]
    a, b = train.main(argv), train.main(argv + ["--check"])
    assert [h["loss"] for h in a["history"]] == \
        [h["loss"] for h in b["history"]]
