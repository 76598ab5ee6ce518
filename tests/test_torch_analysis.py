"""The port's comm-safety analyzer (``repro_torch.analysis``) held against
the JAX package's (``repro.analysis``) on the same inputs.

Diagnostics compare as sets of (rule, severity, subject, message); the
JAX side runs eagerly on the CPU. The card's rules (``CARD-*``) have no
JAX counterpart and are held to their own fixtures here and to the
planted requests of ``tests/test_torch_analysis_launch.py``; the trace
lane is ``tests/test_torch_analysis_trace.py``.
"""
import os
import sys

import pytest

from repro.analysis import choreography as j_choreo
from repro.analysis import commcheck as jcc
from repro.analysis import frames as j_frames
from repro.analysis import layout as j_layout
from repro.analysis import mutations as j_mut
from repro.analysis import sites as j_sites
from repro.analysis import vmem as j_vmem
from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import lowering_plan as j_lowering_plan
from repro.models.config import INPUT_SHAPES as J_SHAPES
from repro.parallel.plan import make_plan as j_make_plan
from repro_torch.analysis import choreography as t_choreo
from repro_torch.analysis import commcheck as tcc
from repro_torch.analysis import frames as t_frames
from repro_torch.analysis import layout as t_layout
from repro_torch.analysis import mutations as t_mut
from repro_torch.analysis import sites as t_sites
from repro_torch.analysis import smem
from repro_torch.analysis.report import RULES
from repro_torch.configs import get_config
from repro_torch.core.comm_config import CommConfig
from repro_torch.core.policy import CommPolicy
from repro_torch.parallel.plan import make_plan

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_threads import one_torch_thread  # noqa: E402,F401


def _key(diags):
    return sorted((d.rule, d.severity, d.subject, d.message) for d in diags)


# ---------------------------------------------------------------------------
# the core static pass, rule by rule
# ---------------------------------------------------------------------------

_CORE = {
    "choreography": (lambda: j_choreo.check_choreography(jcc.TP_VALUES),
                     lambda: t_choreo.check_choreography(tcc.TP_VALUES)),
    "layouts": (j_layout.check_layouts, t_layout.check_layouts),
    # the JAX package's block-chooser sweep and the port's codec contract
    # check the same 24 shapes
    "codec contract": (j_vmem.check_vmem_static, smem.check_codec_static),
    "frames": (j_frames.check_frames, t_frames.check_frames),
}


@pytest.mark.parametrize("part", sorted(_CORE))
def test_core_part_matches_jax(part):
    (jd, jn), (td, tn) = _CORE[part][0](), _CORE[part][1]()
    assert jn == tn and _key(jd) == _key(td)


def test_core_report_matches_jax():
    j, t = jcc.core_report(), tcc.core_report()
    assert t.checked == j.checked and _key(t.diags) == _key(j.diags)
    assert t.ok and t.checked == 294


def test_rules_are_jax_rules_but_vmem():
    """Every JAX rule id and description, but the two VMEM rules and
    SITE-FUSED-MESH's reworded description; the card's rules instead."""
    from repro.analysis.report import RULES as J_RULES
    same = set(J_RULES) - {"VMEM-OVERFLOW", "VMEM-BLOCK", "SITE-FUSED-MESH"}
    assert {r: RULES[r] for r in same} == {r: J_RULES[r] for r in same}
    card = {r for r in RULES if r.startswith("CARD-")}
    assert set(RULES) == same | card | {"SITE-FUSED-MESH"}
    assert len(card) == 7


# ---------------------------------------------------------------------------
# the self-test fixtures
# ---------------------------------------------------------------------------

def test_every_fixture_fires_its_rule():
    for name, (fn, rule) in sorted(t_mut.FIXTURES.items()):
        assert rule in {d.rule for d in fn()}, name


def test_fixtures_cover_rules_and_jax_fixtures():
    shared = set(j_mut.FIXTURES) & set(t_mut.FIXTURES)
    assert shared == set(j_mut.FIXTURES) - {"vmem_overflow",
                                             "vmem_a2a_overflow"}
    fired = {rule for _, rule in t_mut.FIXTURES.values()}
    # as in the JAX package: SITE-TRACE is the trace lane's
    # (test_trace_catches_bypass), LAYOUT-LANES a warning of real widths
    # (test_launch_report_off_card_matches_jax), SITE-SEGMENT an
    # invariant no policy breaks
    assert set(RULES) - fired == {"SITE-TRACE", "LAYOUT-LANES",
                                  "SITE-SEGMENT"}
    passed, failed = t_mut.run_selftest()
    assert not failed and len(passed) == len(t_mut.FIXTURES)
    assert tcc.selftest_report().ok


def test_shared_fixtures_match_jax():
    for name in sorted(set(j_mut.FIXTURES) & set(t_mut.FIXTURES)):
        (jf, jr), (tf, tr) = j_mut.FIXTURES[name], t_mut.FIXTURES[name]
        assert jr == tr, name
        assert _key(jf()) == _key(tf()), name


# ---------------------------------------------------------------------------
# the site lint and the launch report, every arch
# ---------------------------------------------------------------------------

def _mesh_plans(arch):
    """(mesh shape, JAX plan, port plan) of each MESH_SHAPES shape that
    plans ``arch``."""
    out = []
    for ms in jcc.MESH_SHAPES:
        try:
            jp = j_make_plan(j_get_config(arch), tp=ms["model"],
                             fsdp=ms.get("data", 1))
        except AssertionError:
            with pytest.raises(AssertionError):
                make_plan(get_config(arch), tp=ms["model"],
                          fsdp=ms.get("data", 1))
            continue
        out.append((ms, jp, make_plan(get_config(arch), tp=ms["model"],
                                      fsdp=ms.get("data", 1))))
    return out


@pytest.fixture(scope="module")
def policies():
    j, t = jcc.shipped_policies(), tcc.shipped_policies()
    assert list(j) == list(t) and len(t) == 8
    return j, t


def test_site_lint_matches_jax(policies):
    """Every arch x shipped policy, and the qgrad alignment at every
    MESH_SHAPES shape that plans the arch."""
    jpols, tpols = policies
    for arch in ARCH_IDS:
        jc, tc = j_get_config(arch), get_config(arch)
        plans = _mesh_plans(arch)
        assert plans, arch
        for name in jpols:
            assert _key(t_sites.check_policy_sites(tc, tpols[name],
                                                   name)) == \
                _key(j_sites.check_policy_sites(jc, jpols[name], name)), \
                (arch, name)
            for ms, jp, tp in plans:
                assert _key(t_sites.check_qgrad_alignment(
                    tc, tp, tpols[name], name)) == _key(
                    j_sites.check_qgrad_alignment(
                        jc, jp, jpols[name], name)), (arch, name, ms)


def test_launch_report_off_card_matches_jax(policies):
    """One lowering pair a mode and arch, every shipped policy and mesh:
    the port's report with ``card=False`` is JAX's with ``tpu=False``."""
    for arch in ARCH_IDS:
        _launch_reports_match(arch, *policies)


def _launch_reports_match(arch, jpols, tpols):
    modes = {}
    for shape in J_SHAPES:
        lp = j_lowering_plan(arch, shape)
        if not lp.skip:
            modes.setdefault(lp.mode, (shape, lp))
    jc, tc = j_get_config(arch), get_config(arch)
    n = 0
    for shape, lp in modes.values():
        shp = J_SHAPES[shape]
        for ms, jp, tp in _mesh_plans(arch):
            if "pod" in ms and lp.mode != "train":
                continue
            for name in jpols:
                kw = dict(global_batch=shp.global_batch, seq=shp.seq_len,
                          n_micro=lp.n_micro or 1, mode=lp.mode,
                          subject=f"{shape}/{name}")
                j = jcc.launch_report(jc, jp, jpols[name], ms, tpu=False,
                                      **kw)
                t = tcc.launch_report(tc, tp, tpols[name], ms, card=False,
                                      **kw)
                assert t.checked == j.checked, (arch, shape, ms, name)
                assert _key(t.diags) == _key(j.diags), (arch, shape, ms,
                                                         name)
                n += 1
    assert n >= 8 * 3, arch


def test_launch_report_finds_a_broken_policy():
    """JAX's test_broken_policy_fails_launch_report on the port."""
    cfg = get_config("moonshot-v1-16b-a3b")
    plan = make_plan(cfg, tp=4, fsdp=2)
    pol = CommPolicy(a2a=CommConfig(bits=4, group=32, scheme="hierarchical"))
    rep = tcc.launch_report(cfg, plan, pol, {"data": 2, "model": 4},
                            global_batch=8, seq=128, mode="train")
    assert not rep.ok and "SITE-SCHEME" in rep.rules_fired()
