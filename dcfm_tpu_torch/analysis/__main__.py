"""CLI of the port's dcfm-lint static-analysis pass.

``python -m dcfm_tpu_torch.analysis [paths...]`` (also reachable as
``dcfm-tpu-torch lint``) lints the given files/directories (default: the
``dcfm_tpu_torch`` package next to this file) through the project-wide
engine (cross-module symbol table, optional content-hash cache,
optional committed baseline): the port of ``python -m
dcfm_tpu.analysis``, with the same flags and exit codes.  ``--gate`` is
the port's whole-tree gate: its own files (:func:`gate_paths`) against
its own baseline (``analysis/lint_baseline.json``), warnings failing.
``--trace`` runs the port's trace gate (analysis/tracecheck.py) on the
card, or on the CPU under ``--device cpu``; without a card and without
``--device cpu`` it exits 2 - it never traces on the CPU unasked.

Exit-code contract (the JAX CLI's; tests/test_torch_analysis.py holds
the two side by side):

* **0** - clean: no findings, or only baselined findings, or only
  findings below the ``--fail-on`` threshold.
* **1** - findings at or above the threshold (default: ``error``
  severity; ``--fail-on warning`` makes warnings fail too - what CI
  uses, so suppression rot still gates the build).
* **2** - usage error (bad flag, nonexistent path, ``--changed``
  without a usable git checkout) or internal crash.

A ``BrokenPipeError`` from ``dcfm-tpu-torch lint ... | head`` is not an
error (same contract as the ``events`` CLI).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

_README_BEGIN = ("<!-- dcfm-torch-lint-rules:begin (generated: "
                 "dcfm-tpu-torch lint --rules-md) -->")
_README_END = "<!-- dcfm-torch-lint-rules:end -->"

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE_BASELINE = os.path.join(_PACKAGE, "analysis", "lint_baseline.json")


def gate_paths(repo: str) -> list:
    """The port's own files in a checkout at ``repo``: the package, its
    tests (``tests/test_torch_*.py`` and the rank scripts
    ``tests/torch_*.py``) and ``chip_smoke.py``."""
    tests = os.path.join(repo, "tests")
    out = [os.path.join(repo, "dcfm_tpu_torch")]
    out += sorted(glob.glob(os.path.join(tests, "test_torch_*.py")))
    out += sorted(glob.glob(os.path.join(tests, "torch_*.py")))
    smoke = os.path.join(repo, "chip_smoke.py")
    return out + ([smoke] if os.path.isfile(smoke) else [])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dcfm-tpu-torch lint",
        description="the port's dcfm-lint: torch/FFI-aware static "
                    "analysis (RNG discipline, CUDA-graph capture "
                    "hygiene, dtype drift, FFI safety, thread shutdown, "
                    "rank-branch collectives, lockset races, host-buffer "
                    "lifetime), and the trace gate over the port's "
                    "graphed trips")
    p.add_argument("paths", nargs="*",
                   help="files or directories to lint (default: the "
                        "dcfm_tpu_torch package)")
    p.add_argument("--gate", action="store_true",
                   help="the port's whole-tree gate: lint dcfm_tpu_torch/, "
                        "tests/test_torch_*.py, tests/torch_*.py and "
                        "chip_smoke.py of this checkout against "
                        "dcfm_tpu_torch/analysis/lint_baseline.json "
                        "(unless --baseline names another) with "
                        "--fail-on warning")
    p.add_argument("--format", choices=("text", "json", "sarif"),
                   default="text")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule registry and exit")
    p.add_argument("--rules-md", action="store_true",
                   help="print the README rule table (markdown) and exit")
    p.add_argument("--check-readme", metavar="README",
                   help="verify the generated rule table between the "
                        f"'{_README_BEGIN[:24]}...' markers in README "
                        "matches --rules-md; exit 1 on drift")
    p.add_argument("--exclude", action="append", default=[],
                   metavar="PATH",
                   help="path prefix to skip (repeatable; e.g. the "
                        "known-bad lint fixtures)")
    p.add_argument("--baseline", metavar="FILE",
                   help="baseline file: findings fingerprinted there "
                        "are suppressed (pre-existing debt does not "
                        "block CI; new findings do)")
    p.add_argument("--write-baseline", action="store_true",
                   help="with --baseline: (re)write the file from the "
                        "current findings and exit 0")
    p.add_argument("--trace", action="store_true",
                   help="run the TRACE-level gate instead of the AST "
                        "lint: run every registered entry once under a "
                        "recording TorchDispatchMode "
                        "(analysis/tracecheck.py) and verify the "
                        "DCFM18xx invariants (collective groups, dtype "
                        "leaks, host syncs, in-place carries, retrace "
                        "sentinel, variates in trips); same "
                        "baseline/format/exit contract")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="with --trace: where the entries run (default: "
                        "the card; no card and no --device cpu exits 2)")
    p.add_argument("--changed", action="store_true",
                   help="lint only files that differ from git HEAD "
                        "(plus untracked files); the symbol table "
                        "still covers the whole tree.  With --trace: "
                        "skip entries whose defining module matches "
                        "HEAD")
    p.add_argument("--cache-file", metavar="FILE",
                   help="per-file analysis cache keyed on content "
                        "hash (cold run populates it; warm runs skip "
                        "unchanged files)")
    p.add_argument("--fail-on", choices=("error", "warning"),
                   default="error",
                   help="lowest severity that fails the build "
                        "(default: error; CI passes 'warning')")
    return p


def _print_rules(rules) -> None:
    for r in rules.values():
        tag = " (library-only)" if r.library_only else ""
        sev = "" if r.severity == "error" else f" [{r.severity}]"
        print(f"{r.id} [{r.name}]{tag}{sev}: {r.summary}")


def rules_markdown(rules) -> str:
    """The generated README rule table.  First sentence of each
    summary only - the registry (--list-rules) carries the full text."""
    lines = ["| ID | Name | Severity | Scope | Summary |",
             "| --- | --- | --- | --- | --- |"]
    for r in rules.values():
        first = r.summary.split(". ")[0].rstrip(".")
        scope = "library" if r.library_only else "all files"
        lines.append(f"| {r.id} | {r.name} | {r.severity} | {scope} "
                     f"| {first} |")
    return "\n".join(lines)


def _check_readme(readme_path: str, rules) -> int:
    try:
        with open(readme_path, "r", encoding="utf-8") as f:
            text = f.read()
    except OSError as e:
        print(f"dcfm-lint: cannot read {readme_path}: {e}",
              file=sys.stderr)
        return 2
    try:
        start = text.index(_README_BEGIN) + len(_README_BEGIN)
        end = text.index(_README_END)
    except ValueError:
        print(f"dcfm-lint: {readme_path} has no "
              f"'{_README_BEGIN}' / '{_README_END}' markers",
              file=sys.stderr)
        return 1
    current = text[start:end].strip()
    expected = rules_markdown(rules).strip()
    if current != expected:
        print("dcfm-lint: README rule table is out of date with the "
              "registry - regenerate it:\n"
              "  python -m dcfm_tpu_torch.analysis --rules-md\n"
              "and paste between the dcfm-torch-lint-rules markers",
              file=sys.stderr)
        return 1
    print("dcfm-lint: README rule table matches the registry")
    return 0


def _trace_line(name: str, result) -> None:
    """One stderr line per entry of the trace gate: what it ran, or why
    not (stdout stays the report's, whatever --format)."""
    if result is None:
        what = "cached"
    elif result.skipped:
        what = f"skipped: {result.skipped}"
    else:
        what = (f"{result.ops} ops in {result.seconds:.2f} s, "
                f"{len(result.findings)} finding(s)")
        if result.tally:
            what += ", capture tally " + json.dumps(
                {k: v for k, v in result.tally.items() if v})
    print(f"dcfm-lint: trace {name}: {what}", file=sys.stderr)


def _run(args) -> int:
    from dcfm_tpu_torch.analysis import baseline as baseline_mod
    from dcfm_tpu_torch.analysis import engine
    from dcfm_tpu_torch.analysis.rules import ALL_RULES

    if args.list_rules:
        _print_rules(ALL_RULES)
        return 0
    if args.rules_md:
        print(rules_markdown(ALL_RULES))
        return 0
    if args.check_readme:
        return _check_readme(args.check_readme, ALL_RULES)
    if args.write_baseline and not args.baseline:
        print("dcfm-lint: --write-baseline requires --baseline FILE",
              file=sys.stderr)
        return 2

    root = os.getcwd()
    if args.trace:
        # Trace-level gate: the registered entries, not file paths.
        import torch

        from dcfm_tpu_torch.analysis import tracecheck
        if args.device == "cuda" and not torch.cuda.is_available():
            print("dcfm-lint: --trace runs the entries on the card and "
                  "torch.cuda.is_available() is false; pass --device cpu "
                  "to trace on the CPU", file=sys.stderr)
            return 2
        try:
            findings = tracecheck.check_project(
                cache_path=args.cache_file, changed_only=args.changed,
                root=root, device=args.device, report=_trace_line)
        except RuntimeError as e:
            print(f"dcfm-lint: {e}", file=sys.stderr)
            return 2
        return _report(args, findings, baseline_mod, engine, ALL_RULES,
                       root, trace_mode=True)

    if args.gate:
        if args.paths:
            print("dcfm-lint: --gate lints the port's own files; give no "
                  "paths", file=sys.stderr)
            return 2
        root = os.path.dirname(_PACKAGE)
        args.baseline = args.baseline or GATE_BASELINE
        args.fail_on = "warning"
    paths = (gate_paths(root) if args.gate else args.paths
             or [_PACKAGE])
    for p in paths:
        if not os.path.exists(p):
            print(f"dcfm-lint: no such path: {p}", file=sys.stderr)
            return 2

    try:
        findings = engine.lint_project(
            paths, exclude=args.exclude, cache_path=args.cache_file,
            changed_only=args.changed, root=root)
    except RuntimeError as e:
        print(f"dcfm-lint: {e}", file=sys.stderr)
        return 2
    return _report(args, findings, baseline_mod, engine, ALL_RULES, root)


def _report(args, findings, baseline_mod, engine, rules, root,
            trace_mode=False) -> int:
    """Shared tail of the AST and trace gates: baseline application,
    severity threshold, and the text/json/sarif reporters - one exit
    contract for both modes.

    The two gates share ONE baseline file, partitioned by rule family:
    each mode applies (and, under --write-baseline, rewrites) only its
    own family's entries, so a trace run never reports the AST debt as
    stale - or wipes it on refresh - and vice versa."""
    from dcfm_tpu_torch.analysis.rules import TRACE_RULES

    def ours(entry) -> bool:
        return (entry.get("rule") in TRACE_RULES) == trace_mode

    if args.baseline and args.write_baseline:
        data = baseline_mod.build_baseline(findings, root)
        prior = baseline_mod.load_baseline(args.baseline)
        if prior is not None:
            foreign = [e for e in prior.get("entries", ())
                       if not ours(e)]
            data["entries"] = sorted(
                foreign + data["entries"],
                key=lambda e: (e["path"], e["rule"], e["fingerprint"]))
        baseline_mod.save_baseline(args.baseline, data)
        print(f"dcfm-lint: wrote {len(data['entries'])} baseline "
              f"entr{'y' if len(data['entries']) == 1 else 'ies'} to "
              f"{args.baseline}")
        return 0

    suppressed, stale = [], []
    if args.baseline:
        data = baseline_mod.load_baseline(args.baseline)
        if data is None:
            print(f"dcfm-lint: unreadable baseline {args.baseline} "
                  "(create it with --write-baseline)", file=sys.stderr)
            return 2
        scoped = dict(data, entries=[
            e for e in data.get("entries", ()) if ours(e)])
        findings, suppressed, stale = baseline_mod.apply_baseline(
            findings, scoped, root)

    def severity(f):
        return rules[f.rule].severity if f.rule in rules else "error"

    failing = [f for f in findings
               if args.fail_on == "warning" or severity(f) == "error"]

    if args.format == "json":
        print(json.dumps([{
            "path": f.path, "line": f.line, "col": f.col,
            "rule": f.rule, "severity": severity(f),
            "message": f.message} for f in findings]))
    elif args.format == "sarif":
        print(json.dumps(engine.to_sarif(findings, root)))
    else:
        for f in findings:
            print(f)
        n = len(findings)
        extras = []
        if suppressed:
            extras.append(f"{len(suppressed)} baselined")
        if stale:
            extras.append(f"{len(stale)} stale baseline entries - "
                          "refresh with --write-baseline")
        extra = f" ({'; '.join(extras)})" if extras else ""
        if n:
            print(f"dcfm-lint: {n} finding{'s' if n != 1 else ''} in "
                  f"{len(set(f.path for f in findings))} file(s)"
                  f"{extra}")
        else:
            print(f"dcfm-lint: clean{extra}")
    return 1 if failing else 0


def main(argv=None) -> int:
    try:
        args = build_parser().parse_args(argv)
        return _run(args)
    except BrokenPipeError:
        # `dcfm-tpu-torch lint ... | head` closing the pipe is not an error;
        # detach stdout so interpreter shutdown doesn't re-raise
        try:
            devnull = os.open(os.devnull, os.O_WRONLY)
            os.dup2(devnull, sys.stdout.fileno())
        except OSError:
            pass
        return 0
    except SystemExit:
        raise
    except Exception as e:          # crash contract: exit 2, not a traceback
        print(f"dcfm-lint: internal error: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
