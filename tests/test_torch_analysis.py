"""The port's static analysis against the JAX package's: the AST lint,
the project engine and its baseline, the CLI, and ``test-isolated``.

Fifteen of the port's AST rules are the JAX package's detectors as they
were, so on the same source every reporter must say the same thing for
them: finding for finding on each file of ``tests/fixtures/lint/``, the
same JSON, SARIF results, baseline fingerprints, ``--changed``
selections and exit codes.  The other fifteen (``rules.TRANSLATED``)
match the torch spelling of their hazards and are held by
tests/test_torch_lint_rules.py.  The port's own gate (``--gate``: its
files against its own baseline) is clean.  New known-bad sources are
written into ``tmp_path``: the JAX whole-tree gate excludes only
``tests/fixtures/lint``.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

from dcfm_tpu.analysis import __main__ as jax_main  # noqa: E402
from dcfm_tpu.analysis import engine as jax_engine  # noqa: E402
from dcfm_tpu.analysis import isolate as jax_isolate  # noqa: E402
from dcfm_tpu.analysis import linter as jax_linter  # noqa: E402
from dcfm_tpu.analysis import rules as jax_rules  # noqa: E402
from dcfm_tpu_torch.analysis import __main__ as port_main  # noqa: E402
from dcfm_tpu_torch.analysis import engine as port_engine  # noqa: E402
from dcfm_tpu_torch.analysis import isolate as port_isolate  # noqa: E402
from dcfm_tpu_torch.analysis import linter as port_linter  # noqa: E402
from dcfm_tpu_torch.analysis import rules as port_rules  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "lint")
FIXTURE_FILES = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".py"))

# fires the shared DCFM501 (a daemon thread) and DCFM502 (no join) in
# both linters
_SHARED_BAD = textwrap.dedent("""\
    import threading


    def start(fn):
        t = threading.Thread(target=fn, daemon=True)
        t.start()
        return t
""")
_STALE_PRAGMA = "x = 1  # dcfm: ignore[DCFM501]\n"


def _rows(findings, rules) -> list:
    """The findings of the shared rules (and DCFM000 syntax errors)."""
    return [(f.rule, f.path, f.line, f.col, f.message,
             rules[f.rule].severity if f.rule in rules else "error")
            for f in findings if f.rule not in port_rules.TRANSLATED]


def _run(main, argv, cwd) -> tuple:
    """``main(argv)`` in ``cwd``: (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    here = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
    finally:
        os.chdir(here)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_lint_file_is_the_jax_linter_finding_for_finding(name):
    path = os.path.join(FIXTURES, name)
    port = _rows(port_linter.lint_file(path), port_rules.ALL_RULES)
    ref = _rows(jax_linter.lint_file(path), jax_rules.ALL_RULES)
    assert port == ref
    with open(path) as f:
        src = f.read()
    assert _rows(port_linter.lint_source(src, path),
                 port_rules.ALL_RULES) == ref
    if name.startswith("bad_") and any(
            f.rule not in port_rules.TRANSLATED
            for f in jax_linter.lint_file(path)):
        assert port


def test_the_rule_registry_is_the_jax_registry():
    """Every AST rule's id, family, scope and severity; the name and
    summary of the shared ones (the translated ones speak of torch); the
    trace ids are JAX's DCFM1800-1808 plus the port's DCFM1809."""
    def fields(rules):
        return [(r.id, r.family, r.library_only, r.severity)
                for r in rules.values()]

    def text(rules):
        return [(r.id, r.name, r.summary) for r in rules.values()
                if r.id not in port_rules.TRANSLATED]
    assert fields(port_rules.RULES) == fields(jax_rules.RULES)
    assert text(port_rules.RULES) == text(jax_rules.RULES)
    for rid in port_rules.TRANSLATED:
        summary = port_rules.RULES[rid].summary
        assert summary != jax_rules.RULES[rid].summary, rid
        assert "jnp" not in summary and "jax." not in summary, rid
    assert list(port_rules.TRACE_RULES) == [*jax_rules.TRACE_RULES,
                                            "DCFM1809"]
    assert {r.name for r in port_rules.TRACE_RULES.values()} >= {
        "trace-entry-error", "dtype-leak", "unstable-trace-key",
        "collective-spans-chains", "collective-spans-hosts",
        "variate-in-trip"}


def test_the_project_engine_is_the_jax_engine_on_the_fixtures():
    """The two-pass engine (cross-module symbol table) over the whole
    fixture directory, also as ``lint_paths``."""
    port = _rows(port_engine.lint_project([FIXTURES], root=REPO),
                 port_rules.ALL_RULES)
    ref = _rows(jax_engine.lint_project([FIXTURES], root=REPO),
                jax_rules.ALL_RULES)
    assert port == ref and len(port) > 30
    assert _rows(port_linter.lint_paths([FIXTURES]),
                 port_rules.ALL_RULES) == _rows(
        jax_linter.lint_paths([FIXTURES]), jax_rules.ALL_RULES)


def test_the_engine_s_worker_pool_gives_the_serial_findings(monkeypatch):
    """A large tree is linted in spawned worker processes; lowered
    thresholds put the fixture directory through them: every finding of
    the serial run, in its order."""
    serial = port_engine.lint_project([FIXTURES], root=REPO)
    monkeypatch.setattr(port_engine, "_POOL_MIN_FILES", 2)
    monkeypatch.setattr(port_engine, "_FILES_PER_WORKER", 16)
    pool = port_engine._pool(len(FIXTURE_FILES))
    assert pool is not None
    pool.shutdown()
    assert port_engine.lint_project([FIXTURES], root=REPO) == serial != []


def test_the_whole_tree_gate_is_clean_against_the_committed_baseline():
    """The port's gate (``--gate``): its own files - the package, its
    tests and rank scripts, chip_smoke.py - against its own baseline,
    warnings failing: exit 0, and nothing baselined."""
    assert os.path.join(REPO, "chip_smoke.py") in port_main.gate_paths(REPO)
    cp = subprocess.run(
        [sys.executable, "-m", "dcfm_tpu_torch.analysis", "--gate"],
        capture_output=True, text=True, cwd=REPO, timeout=600)
    assert cp.returncode == 0, cp.stdout + cp.stderr
    assert cp.stdout.strip().splitlines()[-1] == "dcfm-lint: clean"


def test_list_rules_prints_the_jax_lines_and_the_trace_rules():
    rc, port, _ = _run(port_main.main, ["--list-rules"], REPO)
    jrc, ref, _ = _run(jax_main.main, ["--list-rules"], REPO)
    assert rc == jrc == 0
    by_id = {line.split()[0]: line for line in port.splitlines()}
    ref_by_id = {line.split()[0]: line for line in ref.splitlines()}
    for rid in jax_rules.RULES:
        if rid in port_rules.TRANSLATED:
            assert by_id[rid].startswith(
                f"{rid} [{port_rules.RULES[rid].name}]")
        else:
            assert by_id[rid] == ref_by_id[rid]
    assert set(by_id) == set(ref_by_id) | {"DCFM1809"}


def _shared(rule: str) -> bool:
    return rule not in port_rules.TRANSLATED


@pytest.mark.parametrize("fmt", ["json", "sarif", "text"])
def test_reports_are_the_jax_reports(fmt):
    """JSON rows, SARIF results (and each shared rule's SARIF metadata)
    and the text report's finding lines over the fixture directory, for
    the shared rules."""
    argv = [FIXTURES, "--format", fmt]
    rc, port, _ = _run(port_main.main, argv, REPO)
    jrc, ref, _ = _run(jax_main.main, argv, REPO)
    assert rc == jrc == 1
    if fmt == "json":
        rows = [[r for r in json.loads(out) if _shared(r["rule"])]
                for out in (port, ref)]
        assert rows[0] == rows[1] != []
    elif fmt == "sarif":
        p, r = json.loads(port), json.loads(ref)
        res = [[x for x in log["runs"][0]["results"]
                if _shared(x["ruleId"])] for log in (p, r)]
        assert res[0] == res[1] != []
        meta = {m["id"]: m for m in r["runs"][0]["tool"]["driver"]["rules"]}
        for m in p["runs"][0]["tool"]["driver"]["rules"]:
            if m["id"] in jax_rules.RULES and _shared(m["id"]):
                assert m == meta[m["id"]]
        assert p["version"] == r["version"] == "2.1.0"
    else:
        lines = [[ln for ln in out.splitlines()
                  if ln.startswith(FIXTURES) and _shared(ln.split()[1])]
                 for out in (port, ref)]
        assert lines[0] == lines[1] != []


def test_write_baseline_writes_the_jax_baseline(tmp_path):
    """The same fingerprints for the shared rules' findings, a baseline
    the port wrote suppresses all of its findings, and ``--gate
    --write-baseline`` writes the committed port baseline (empty: the
    gate's findings are fixed or carry reasoned pragmas)."""
    pb, jb = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    for main, path in ((port_main.main, pb), (jax_main.main, jb)):
        rc, out, _ = _run(main, [FIXTURES, "--baseline", path,
                                 "--write-baseline"], REPO)
        assert rc == 0 and "baseline entr" in out
    with open(pb) as f, open(jb) as g:
        entries = [[e for e in json.load(h)["entries"] if _shared(e["rule"])]
                   for h in (f, g)]
    assert entries[0] == entries[1] != []
    rc, out, _ = _run(port_main.main, [FIXTURES, "--baseline", pb,
                                       "--fail-on", "warning"], REPO)
    assert rc == 0 and "baselined" in out
    gb = str(tmp_path / "gate.json")
    rc, out, _ = _run(port_main.main, ["--gate", "--baseline", gb,
                                       "--write-baseline"], REPO)
    assert rc == 0 and "wrote 0 baseline entries" in out
    with open(gb) as f, open(port_main.GATE_BASELINE) as g:
        assert json.load(f) == json.load(g) == {"entries": [],
                                                 "version": 1}


def _git(cwd, *args):
    subprocess.run(["git", "-c", "user.email=t@example.com", "-c",
                    "user.name=t", *args], cwd=cwd, check=True,
                   capture_output=True)


def test_changed_lints_what_git_head_does_not_have(tmp_path):
    """--changed on a git tree: a committed bad file is skipped, a
    modified one and an untracked one are linted - in both packages."""
    (tmp_path / "old.py").write_text(_SHARED_BAD)
    (tmp_path / "edited.py").write_text("x = 1\n")
    _git(tmp_path, "init", "-q")
    _git(tmp_path, "add", "-A")
    _git(tmp_path, "commit", "-q", "-m", "seed")
    (tmp_path / "edited.py").write_text(_SHARED_BAD)
    (tmp_path / "new.py").write_text(_SHARED_BAD)
    argv = [".", "--changed", "--format", "json"]
    rc, port, _ = _run(port_main.main, argv, str(tmp_path))
    jrc, ref, _ = _run(jax_main.main, argv, str(tmp_path))
    assert rc == jrc == 1
    assert json.loads(port) == json.loads(ref)
    assert sorted({os.path.basename(f["path"]) for f in
                   json.loads(port)}) == ["edited.py", "new.py"]


def _exit_case(tmp_path, case) -> list:
    bad, stale = tmp_path / "bad.py", tmp_path / "stale.py"
    bad.write_text(_SHARED_BAD)
    stale.write_text(_STALE_PRAGMA)
    return {
        "clean": [os.path.join(FIXTURES, "good_rng.py")],
        "error": [str(bad)],
        "warning-under-error": [str(stale)],
        "warning-under-warning": [str(stale), "--fail-on", "warning"],
        "no-such-path": [str(tmp_path / "missing.py")],
        "write-without-baseline": [str(bad), "--write-baseline"],
        "unreadable-baseline": [str(bad), "--baseline",
                                str(tmp_path / "none.json")],
        "bad-flag": ["--format", "yaml"],
    }[case]


@pytest.mark.parametrize("case,code", [
    ("clean", 0), ("error", 1), ("warning-under-error", 0),
    ("warning-under-warning", 1), ("no-such-path", 2),
    ("write-without-baseline", 2), ("unreadable-baseline", 2),
    ("bad-flag", 2)])
def test_exit_codes_are_the_jax_cli_s(tmp_path, case, code):
    argv = _exit_case(tmp_path, case)
    codes = []
    for main in (port_main.main, jax_main.main):
        try:
            codes.append(_run(main, argv, REPO)[0])
        except SystemExit as e:             # argparse's usage error
            codes.append(e.code)
    assert codes == [code, code]


def test_the_readme_holds_both_rule_tables():
    """The port's generated table between its own markers, and the JAX
    table between the JAX markers, each matching its registry."""
    rc, out, _ = _run(port_main.main, ["--check-readme", "README.md"], REPO)
    assert rc == 0 and "matches" in out
    rc, out, _ = _run(jax_main.main, ["--check-readme", "README.md"], REPO)
    assert rc == 0 and "matches" in out
    rc, table, _ = _run(port_main.main, ["--rules-md"], REPO)
    assert rc == 0 and "| DCFM1809 | variate-in-trip |" in table


def test_the_cli_runs_the_port_s_lint():
    """``dcfm-tpu-torch lint`` is this package's CLI, dispatched before
    the fit parser (its flags are the linter's)."""
    cp = subprocess.run(
        [sys.executable, "-m", "dcfm_tpu_torch.cli", "lint", "--format",
         "json", os.path.join(FIXTURES, "bad_thread.py")],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    rc, ref, _ = _run(jax_main.main, [os.path.join(FIXTURES,
                                                   "bad_thread.py"),
                                      "--format", "json"], REPO)
    assert (cp.returncode, json.loads(cp.stdout)) == (rc, json.loads(ref))


def _isolated(run_isolated, files) -> tuple:
    buf = io.StringIO()
    rc = run_isolated(files, ["-q", "-p", "no:cacheprovider"], out=buf)
    lines = [re.sub(r"[0-9.]+s\)$", "T)", line)
             for line in buf.getvalue().splitlines()
             if line.startswith(("[isolated]", "ISOLATED SUMMARY"))]
    return rc, lines


def test_test_isolated_reports_as_the_jax_runner(tmp_path):
    """One passing file, one failing file and one that aborts: the same
    per-file outcomes (SIGABRT named), summary line and exit code.  The
    CLI route (``dcfm-tpu-torch test-isolated``) is held by
    tests/test_torch_cli.py."""
    (tmp_path / "test_ok.py").write_text("def test_ok():\n    assert True\n")
    (tmp_path / "test_fails.py").write_text(
        "def test_fails():\n    assert 1 == 2\n")
    (tmp_path / "test_aborts.py").write_text(
        "import os\n\n\ndef test_aborts():\n    os.abort()\n")
    files = sorted(str(p) for p in tmp_path.glob("test_*.py"))
    port = _isolated(port_isolate.run_isolated, files)
    ref = _isolated(jax_isolate.run_isolated, files)
    assert port == ref
    rc, lines = port
    assert rc == 1
    assert any("CRASH" in line and "SIGABRT" in line for line in lines)
    assert lines[-1] == ("ISOLATED SUMMARY: 1 file(s) passed, 1 failed, 1 "
                         f"crashed [{tmp_path / 'test_aborts.py'}:SIGABRT]")
    assert port_isolate._signal_name(-6) == jax_isolate._signal_name(-6) \
        == "SIGABRT"
