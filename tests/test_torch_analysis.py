"""ytpu-lint of the PyTorch port: the cases of ``tests/test_analysis.py``
on the port's copy of the framework (``yjs_tpu_torch.analysis``), and
the port held to the JAX package's copy.

1. the fixture corpus under tests/fixtures/lint/ (parsed, never
   imported) — every known-bad file is flagged with its expected rule
   id, every known-clean file is silent, and for every fixture the
   port's runner and the JAX runner report the same findings (rule,
   path, symbol, fingerprint);
2. the escape hatches — suppressions and the baseline are
   self-verifying;
3. the port itself — its full sweep (``yjs_tpu_torch/``,
   ``chip_smoke.py``, ``scripts/torch_*.py``) against the port's
   baseline (``.ytpu-lint-torch-baseline.json``) comes back with zero
   unsuppressed findings and no stale entry, which is exactly the
   ``scripts/torch_ytpu_lint.py --ci`` gate; the donation and retrace
   checkers find no jitted callable in the port (it has none); and the
   live registry of a CPU provider and fleet agrees with the README.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from yjs_tpu_torch.analysis import (
    Baseline,
    Finding,
    RULE_BARE_SUPPRESSION,
    RULE_DISCIPLINE,
    RULE_DONATION,
    RULE_FORCE,
    RULE_KNOB,
    RULE_METRIC,
    RULE_ORDERING,
    RULE_RETRACE,
    RULE_TRACE,
    RULE_USELESS_SUPPRESSION,
    RULE_WAL_KIND,
    all_rules,
    default_checkers,
    parse_suppressions,
    run_lint,
)

pytestmark = pytest.mark.analysis

ROOT = Path(__file__).resolve().parent.parent
FIX = Path(__file__).resolve().parent / "fixtures" / "lint"


def lint(target, root=FIX, **kw):
    """One fixture (file or mini-project dir) through the full runner.

    exclude=() because the corpus lives under tests/, which the
    repo-level default excludes."""
    kw.setdefault("emit_metrics", False)
    return run_lint(root, targets=[target], exclude=(), **kw)


def rules_of(result):
    return sorted(f.rule for f in result.findings)


# -- 1. fixture corpus: every known-bad flagged, every clean silent --------

BAD = [
    ("donation_read_after.py", [RULE_DONATION]),
    ("donation_splat.py", [RULE_DONATION]),
    ("retrace_inline_ctor.py", [RULE_RETRACE]),
    ("retrace_static_argnum.py", [RULE_RETRACE]),
    ("locks_unguarded_read.py", [RULE_DISCIPLINE]),
    ("locks_ordering_cycle.py", [RULE_ORDERING]),
    ("seams_bad_ingress.py", [RULE_TRACE, RULE_TRACE]),
    ("seams_bad_cluster_ingress.py",
     [RULE_TRACE, RULE_TRACE, RULE_TRACE, RULE_TRACE]),
    ("seams_bad_force.py", [RULE_FORCE]),
]

CLEAN = [
    "donation_clean.py",
    "retrace_clean.py",
    "retrace_clean_pad_pow2.py",
    "locks_clean.py",
    "seams_clean.py",
    "seams_clean_cluster.py",
]


@pytest.mark.parametrize("name,expected", BAD, ids=[b[0] for b in BAD])
def test_known_bad_fixture_flagged(name, expected):
    result = lint(FIX / name)
    assert rules_of(result) == sorted(expected), [
        f.render() for f in result.findings
    ]
    assert result.failed


@pytest.mark.parametrize("name", CLEAN)
def test_known_clean_fixture_silent(name):
    result = lint(FIX / name)
    assert result.findings == [], [f.render() for f in result.findings]
    assert not result.failed


def test_finding_severity_matches_registered_rule():
    registered = all_rules()
    for name, _expected in BAD:
        for f in lint(FIX / name).findings:
            assert f.severity == registered[f.rule]


def test_donation_finding_points_at_the_read():
    result = lint(FIX / "donation_read_after.py")
    (f,) = result.findings
    assert f.severity == "error"
    assert "dyn" in f.message and "step" in f.message
    # anchored on the read line, not the call line
    assert "BAD" in (FIX / "donation_read_after.py").read_text().splitlines()[
        f.line - 1
    ]


def test_wal_kind_bad_project():
    result = lint(FIX / "walmod_bad", root=FIX / "walmod_bad")
    assert rules_of(result) == [RULE_WAL_KIND, RULE_WAL_KIND]
    # one finding for the unmapped KIND_NAMES entry, one for the
    # handler module that never references the kind
    assert {f.path for f in result.findings} == {
        "persistence/records.py",
        "persistence/recovery.py",
    }
    assert all(f.symbol == "KIND_ROTATE" for f in result.findings)


def test_wal_kind_clean_project():
    result = lint(FIX / "walmod_clean", root=FIX / "walmod_clean")
    assert result.findings == [], [f.render() for f in result.findings]


def test_drift_bad_project_all_four_directions():
    # the mini-project dir IS the whole project, so opt the stale-docs
    # direction back in (explicit targets turn it off by default)
    result = lint(
        FIX / "driftproj_bad",
        root=FIX / "driftproj_bad",
        checkers=default_checkers(),
    )
    by_rule = {}
    for f in result.findings:
        by_rule.setdefault(f.rule, set()).add(f.symbol)
    assert by_rule[RULE_KNOB] == {"YTPU_SECRET_DEPTH", "YTPU_WAL_GHOST_KNOB"}
    assert by_rule[RULE_METRIC] == {
        "ytpu_hidden_total",
        "ytpu_ghost_metric_total",
    }
    # stale-docs findings anchor on the README, code drift on the code
    paths = {(f.rule, f.symbol): f.path for f in result.findings}
    assert paths[(RULE_KNOB, "YTPU_SECRET_DEPTH")] == "app.py"
    assert paths[(RULE_KNOB, "YTPU_WAL_GHOST_KNOB")] == "README.md"


def test_drift_clean_project_silent():
    result = lint(
        FIX / "driftproj_clean",
        root=FIX / "driftproj_clean",
        checkers=default_checkers(),
    )
    assert result.findings == [], [f.render() for f in result.findings]


def test_partial_target_run_skips_stale_docs_direction():
    # linting ONE file of a project must not call every knob the file
    # doesn't read "stale docs" — only the code -> README direction runs
    result = lint(FIX / "driftproj_bad" / "app.py", root=FIX / "driftproj_bad")
    assert {f.symbol for f in result.findings} == {
        "YTPU_SECRET_DEPTH",
        "ytpu_hidden_total",
    }


# -- 2. escape hatches: suppressions and baseline are self-verifying -------

def test_reasoned_suppression_silences_and_is_counted():
    result = lint(FIX / "suppressed_ok.py")
    assert result.findings == [], [f.render() for f in result.findings]
    assert [f.rule for f in result.suppressed] == [RULE_DONATION]


def test_deleting_a_suppression_reproduces_the_finding(tmp_path):
    text = (FIX / "suppressed_ok.py").read_text()
    stripped = re.sub(r"\s*# ytpu-lint:[^\n]*", "", text)
    target = tmp_path / "suppressed_ok.py"
    target.write_text(stripped)
    result = lint(target, root=tmp_path)
    assert rules_of(result) == [RULE_DONATION]


def test_bare_suppression_is_reported():
    result = lint(FIX / "suppressed_bare.py")
    assert rules_of(result) == [RULE_BARE_SUPPRESSION]
    # the disable still worked — the donation finding is suppressed,
    # but the missing reason is a finding of its own
    assert [f.rule for f in result.suppressed] == [RULE_DONATION]


def test_useless_suppression_is_reported():
    result = lint(FIX / "suppressed_useless.py")
    assert rules_of(result) == [RULE_USELESS_SUPPRESSION]


def test_docstring_example_is_not_a_suppression():
    text = (
        '"""Example::\n\n'
        "    x = f(buf)  # ytpu-lint: disable=donation-aliasing -- demo\n"
        '"""\n'
        "y = 1  # ytpu-lint: disable=retrace-hazard -- real comment\n"
    )
    sups = parse_suppressions("demo.py", text)
    assert len(sups) == 1
    assert sups[0].rules == ("retrace-hazard",)
    assert sups[0].reason == "real comment"


def test_baseline_covers_then_goes_stale(tmp_path):
    bad = FIX / "donation_read_after.py"
    (finding,) = lint(bad).findings

    baseline = Baseline([Baseline.entry_for(finding, note="grandfathered")])
    covered = lint(bad, baseline=baseline)
    assert covered.findings == [] and not covered.failed
    assert [f.rule for f in covered.baselined] == [RULE_DONATION]

    # deleting the baseline entry reproduces the finding
    reproduced = lint(bad, baseline=Baseline([]))
    assert rules_of(reproduced) == [RULE_DONATION]

    # an entry matching nothing is stale and fails the run
    ghost = Finding(
        rule=RULE_DONATION,
        severity="error",
        path="gone.py",
        line=1,
        message="was fixed long ago",
    )
    stale = lint(bad, baseline=Baseline(
        [Baseline.entry_for(finding), Baseline.entry_for(ghost)]
    ))
    assert stale.failed
    assert [e["path"] for e in stale.stale_baseline] == ["gone.py"]


def test_fingerprint_ignores_line_numbers():
    a = Finding(
        rule=RULE_DONATION, severity="error", path="x.py",
        line=10, message="m", symbol="f",
    )
    b = Finding(
        rule=RULE_DONATION, severity="error", path="x.py",
        line=99, message="m", symbol="f",
    )
    assert a.fingerprint == b.fingerprint
    assert a.fingerprint != Finding(
        rule=RULE_DONATION, severity="error", path="y.py",
        line=10, message="m", symbol="f",
    ).fingerprint


# -- 3. the repo itself: the --ci gate in-process and end-to-end -----------

def test_all_nine_rules_registered():
    rules = all_rules()
    for rule in (
        RULE_DONATION, RULE_RETRACE, RULE_DISCIPLINE, RULE_ORDERING,
        RULE_TRACE, RULE_WAL_KIND, RULE_FORCE, RULE_KNOB, RULE_METRIC,
    ):
        assert rule in rules


def test_repo_self_lint_zero_unsuppressed():
    baseline = Baseline.load(ROOT / ".ytpu-lint-torch-baseline.json")
    result = run_lint(ROOT, baseline=baseline, emit_metrics=False)
    assert result.findings == [], [f.render() for f in result.findings]
    assert result.stale_baseline == []
    assert not result.failed


def test_lint_metric_emitted_on_global_registry():
    from yjs_tpu_torch.obs import global_registry

    run_lint(
        FIX,
        targets=[FIX / "donation_read_after.py"],
        exclude=(),
        emit_metrics=True,
    )
    assert "ytpu_lint_findings_total" in set(global_registry().names())


def test_cli_ci_gate_and_json(tmp_path):
    proc = subprocess.run(
        [sys.executable, "scripts/torch_ytpu_lint.py", "--ci", "--json"],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["findings"] == []


# -- 4. the port against the JAX package's framework ------------------------

PROJECTS = ["walmod_bad", "walmod_clean", "driftproj_bad", "driftproj_clean"]
FILES = sorted(
    {n for n, _ in BAD} | set(CLEAN)
    | {"suppressed_ok.py", "suppressed_bare.py", "suppressed_useless.py"}
)


def _keyed(findings):
    return sorted(
        (f.rule, f.path, f.symbol, f.fingerprint, f.severity)
        for f in findings
    )


@pytest.mark.parametrize("name", FILES + PROJECTS)
def test_same_findings_as_the_jax_framework(name):
    import yjs_tpu.analysis as jax_lint

    if name in PROJECTS:
        # a mini-project is the whole project: docs direction on
        port = lint(FIX / name, root=FIX / name, checkers=default_checkers())
        ref = jax_lint.run_lint(
            FIX / name, targets=[FIX / name], exclude=(), emit_metrics=False,
            checkers=jax_lint.default_checkers(),
        )
    else:
        port = lint(FIX / name)
        ref = jax_lint.run_lint(
            FIX, targets=[FIX / name], exclude=(), emit_metrics=False,
        )
    assert _keyed(port.findings) == _keyed(ref.findings)
    assert _keyed(port.suppressed) == _keyed(ref.suppressed)
    assert port.failed == ref.failed


def test_rule_registry_matches_the_jax_framework():
    import yjs_tpu.analysis as jax_lint

    assert all_rules() == jax_lint.all_rules()


def test_port_full_sweep_targets():
    from yjs_tpu_torch.analysis import default_targets

    targets = default_targets(ROOT)
    assert targets[0] == ROOT / "yjs_tpu_torch"
    assert ROOT / "chip_smoke.py" in targets
    scripts = [t for t in targets if t.parent == ROOT / "scripts"]
    assert scripts and all(t.name.startswith("torch_") for t in scripts)
    assert ROOT / "scripts" / "torch_ytpu_lint.py" in scripts
    assert ROOT / "scripts" / "torch_ytpu_cluster.py" in scripts
    assert not any("yjs_tpu" == t.name or t.name == "bench.py"
                   for t in targets)


def test_port_baseline_entries_carry_a_reason():
    entries = json.loads(
        (ROOT / ".ytpu-lint-torch-baseline.json").read_text()
    )
    assert all(e.get("note", "").strip() for e in entries), entries


def test_port_has_no_jitted_callables():
    """The donation and retrace checkers register ``jax.jit`` callables;
    the port has none, so over the port they register and find
    nothing."""
    from yjs_tpu_torch.analysis import (
        DonationChecker,
        ProjectIndex,
        RetraceChecker,
        iter_python_files,
    )
    from yjs_tpu_torch.analysis.runner import DEFAULT_EXCLUDE, default_targets

    paths = iter_python_files(default_targets(ROOT), exclude=DEFAULT_EXCLUDE)
    index = ProjectIndex(ROOT, paths)
    assert len(index.files) > 50
    assert index.jit_registry == {}
    assert index.jit_factories == {}
    assert list(DonationChecker().check(index)) == []
    assert list(RetraceChecker().check(index)) == []


def test_readme_contract_holds_for_the_port_in_both_directions():
    """With the README's docs direction on, the port reads every
    documented knob and registers or names every documented metric
    family, as the JAX package's framework judges it too."""
    import yjs_tpu.analysis as jax_lint

    result = jax_lint.run_lint(
        ROOT, targets=[ROOT / "yjs_tpu_torch"],
        checkers=jax_lint.default_checkers(stale_docs=True),
        emit_metrics=False,
    )
    drift = [f for f in result.findings
             if f.rule in (RULE_KNOB, RULE_METRIC)]
    assert drift == [], [f.render() for f in drift]


def test_live_comparison_on_the_cpu_is_clean():
    from yjs_tpu_torch.analysis import live_comparison

    assert live_comparison(ROOT, device="cpu") == []
