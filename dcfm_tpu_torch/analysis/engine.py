"""Project-wide analysis engine: symbol table, cache, SARIF.

The per-file linter (analysis/linter.py) stays pure and single-file;
this module is the orchestration layer that turns it into a project
analysis:

* **two-pass scan**: pass 1 parses every file once and collects the
  cross-module symbol table (:class:`Project`) - classes whose methods
  are Thread targets in *other* modules (locks.py), loader helpers
  whose returns carry numpy provenance, and module-level jit entry
  points (lifetime.py).  Pass 2 lints each file with that context.
* **content-hash cache**: both passes are cached per file, keyed on
  the sha256 of the file bytes plus an engine/rules version stamp; the
  findings pass is additionally keyed on the project-table hash, so a
  summary change in one module correctly re-lints its consumers.  The
  cache is a single JSON file written atomically; a missing/corrupt
  cache is ignored, never fatal.
* **--changed**: pass 1 still covers the whole tree (cheap when
  cached - that is what keeps cross-module results correct), pass 2 is
  restricted to files that differ from git HEAD (plus untracked files).
* **SARIF 2.1.0** serialization for code-scanning uploads, beside the
  text/JSON reporters in __main__.py.

The port's copy of ``dcfm_tpu/analysis/engine.py``: the same code, so the
same findings on the same source (held finding for finding by
tests/test_torch_analysis.py).
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import subprocess
import tempfile
from typing import Iterable, Optional

from dcfm_tpu_torch.analysis import lifetime, locks
from dcfm_tpu_torch.analysis.linter import Finding, _Module, lint_source
from dcfm_tpu_torch.analysis.rules import ALL_RULES, RULES

# bumped whenever analysis semantics change so stale caches self-expire;
# the rules-registry digest is folded in as well
ENGINE_VERSION = 1

_SKIP_DIRS = {"__pycache__", ".git", ".jax_cache", ".pytest_cache",
              ".hypothesis"}


class Project:
    """Cross-module symbol table handed to the per-file checkers."""

    def __init__(self):
        self.threaded_classes: set = set()
        self.tainted_returners: set = set()
        self.jit_entries: set = set()

    @classmethod
    def from_summaries(cls, summaries: Iterable[dict]) -> "Project":
        p = cls()
        for s in summaries:
            p.threaded_classes.update(s.get("threaded_classes", ()))
            p.tainted_returners.update(s.get("tainted_returners", ()))
            p.jit_entries.update(s.get("jit_entries", ()))
        return p

    def digest(self) -> str:
        blob = json.dumps({
            "threaded_classes": sorted(self.threaded_classes),
            "tainted_returners": sorted(self.tainted_returners),
            "jit_entries": sorted(self.jit_entries),
        }, sort_keys=True)
        return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def _rules_digest() -> str:
    blob = json.dumps(sorted(
        (r.id, r.name, r.family, r.summary, r.library_only, r.severity)
        for r in RULES.values()))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def _version_stamp() -> str:
    return f"{ENGINE_VERSION}:{_rules_digest()}"


def collect_files(paths: Iterable[str], exclude: Iterable[str] = ()) -> list:
    """All .py files under ``paths``, minus any whose absolute path
    starts with an ``exclude`` prefix."""
    ex = [os.path.abspath(e) for e in exclude]

    def excluded(p: str) -> bool:
        ap = os.path.abspath(p)
        return any(ap == e or ap.startswith(e + os.sep) for e in ex)

    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs
                           if d not in _SKIP_DIRS
                           and not excluded(os.path.join(root, d))]
                for fn in sorted(files):
                    full = os.path.join(root, fn)
                    if fn.endswith(".py") and not excluded(full):
                        out.append(full)
        elif p.endswith(".py") and not excluded(p):
            out.append(p)
    return sorted(set(out))


def _module_dotted(path: str) -> str:
    """Dotted module name for the cross-module symbol table, anchored
    at the innermost 'dcfm_tpu' path segment (files outside the package
    key by their stem - scripts can't be imported cross-module anyway)."""
    parts = os.path.abspath(path).replace("\\", "/").split("/")
    stem = parts[-1][:-3] if parts[-1].endswith(".py") else parts[-1]
    if "dcfm_tpu" in parts[:-1]:
        i = len(parts) - 2 - parts[-2::-1].index("dcfm_tpu")
        pkg = parts[i:-1] + ([] if stem == "__init__" else [stem])
        return ".".join(pkg)
    return stem


def _summarize(source: str, path: str) -> dict:
    """Pass-1 product for one file: its symbol-table contribution."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return {}
    mod = _Module(tree, source, path)
    out = {"threaded_classes": sorted(locks.collect_threaded_classes(mod))}
    out.update(lifetime.collect_lifetime_summary(mod, _module_dotted(path)))
    return out


# -- cache ------------------------------------------------------------

def _load_cache(cache_path: Optional[str]) -> dict:
    if not cache_path:
        return {}
    try:
        with open(cache_path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(data, dict) \
            or data.get("version") != _version_stamp():
        return {}
    files = data.get("files")
    return files if isinstance(files, dict) else {}


def _save_cache(cache_path: Optional[str], files: dict) -> None:
    if not cache_path:
        return
    d = os.path.dirname(os.path.abspath(cache_path)) or "."
    try:
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".lintcache-",
                                   suffix=".tmp")
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump({"version": _version_stamp(), "files": files}, f)
        os.replace(tmp, cache_path)
    except OSError:
        pass                          # cache is an optimization, never fatal


def _changed_files(root: str) -> Optional[set]:
    """Absolute paths of files that differ from git HEAD (tracked
    modifications plus untracked files); None if git is unusable."""
    out: set = set()
    for args in (["git", "diff", "--name-only", "HEAD"],
                 ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            proc = subprocess.run(args, cwd=root, capture_output=True,
                                  text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if proc.returncode != 0:
            return None
        for line in proc.stdout.splitlines():
            line = line.strip()
            if line:
                out.add(os.path.abspath(os.path.join(root, line)))
    return out


def lint_project(paths: Iterable[str], *, exclude: Iterable[str] = (),
                 cache_path: Optional[str] = None,
                 changed_only: bool = False,
                 root: Optional[str] = None) -> list:
    """Project-aware lint over ``paths``; the drop-in upgrade behind
    :func:`dcfm_tpu.analysis.lint_paths`."""
    root = os.path.abspath(root or os.getcwd())
    files = collect_files(paths, exclude)
    cache = _load_cache(cache_path)

    # pass 1: hashes + symbol-table summaries (cached per content hash)
    sources: dict = {}
    hashes: dict = {}
    summaries: list = []
    new_cache: dict = {}
    for path in files:
        ap = os.path.abspath(path)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            continue
        sha = hashlib.sha256(raw).hexdigest()
        hashes[ap] = sha
        entry = cache.get(ap)
        if entry and entry.get("sha") == sha and "summary" in entry:
            summary = entry["summary"]
        else:
            source = raw.decode("utf-8", errors="replace")
            sources[ap] = source
            summary = _summarize(source, path)
        summaries.append(summary)
        new_cache[ap] = {"sha": sha, "summary": summary}

    project = Project.from_summaries(summaries)
    project_sha = project.digest()

    # pass 2: per-file findings (cached on content hash + project hash)
    targets = files
    if changed_only:
        changed = _changed_files(root)
        if changed is None:
            raise RuntimeError(
                "--changed needs a usable git checkout at "
                f"{root} (git diff/ls-files failed)")
        targets = [p for p in files if os.path.abspath(p) in changed]

    findings: list = []
    for path in targets:
        ap = os.path.abspath(path)
        if ap not in hashes:
            continue
        entry = cache.get(ap)
        if (entry and entry.get("sha") == hashes[ap]
                and entry.get("project_sha") == project_sha
                and "findings" in entry):
            cached = [Finding(*row) for row in entry["findings"]]
        else:
            if ap not in sources:
                with open(path, "rb") as f:
                    sources[ap] = f.read().decode("utf-8",
                                                  errors="replace")
            cached = lint_source(sources[ap], path, project=project)
        new_cache[ap]["project_sha"] = project_sha
        new_cache[ap]["findings"] = [
            [f.path, f.line, f.col, f.rule, f.message] for f in cached]
        findings.extend(cached)

    _save_cache(cache_path, new_cache)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


# -- SARIF ------------------------------------------------------------

_SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                 "master/Schemata/sarif-schema-2.1.0.json")


def to_sarif(findings: Iterable, root: Optional[str] = None) -> dict:
    """SARIF 2.1.0 log for code-scanning uploads: one run, the full
    rule registry (AST + trace rules) as the driver's rule metadata,
    severity mapped to SARIF level (error/warning)."""
    root = os.path.abspath(root or os.getcwd())
    rules = [{
        "id": r.id,
        "name": r.name,
        "shortDescription": {"text": f"{r.family}: {r.name}"},
        "fullDescription": {"text": r.summary},
        "defaultConfiguration": {"level": r.severity},
    } for r in ALL_RULES.values()]
    results = []
    for f in findings:
        try:
            uri = os.path.relpath(os.path.abspath(f.path),
                                  root).replace("\\", "/")
        except ValueError:
            uri = f.path.replace("\\", "/")
        level = (ALL_RULES[f.rule].severity
                 if f.rule in ALL_RULES else "error")
        results.append({
            "ruleId": f.rule,
            "level": level,
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": uri},
                    "region": {"startLine": max(f.line, 1),
                               "startColumn": f.col + 1},
                },
            }],
        })
    return {
        "$schema": _SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "dcfm-lint",
                "informationUri":
                    "https://github.com/dcfm-tpu/dcfm-tpu",
                "rules": rules,
            }},
            "results": results,
        }],
    }
