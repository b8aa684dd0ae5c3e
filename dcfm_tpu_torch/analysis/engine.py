"""Project-wide analysis engine: symbol table, cache, SARIF.

The per-file linter (analysis/linter.py) stays pure and single-file;
this module is the orchestration layer that turns it into a project
analysis:

* **two-pass scan**: pass 1 parses every file once and collects the
  cross-module symbol table (:class:`Project`) - classes whose methods
  are Thread targets in *other* modules (locks.py), loader helpers
  whose returns carry numpy provenance (lifetime.py), and each module's
  captured functions and call edges (linter.py).  Pass 2 lints each
  file with that context.
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
* **worker processes**: both passes are per file, so a large tree is
  summarized and linted in worker processes (:func:`_map`), with the
  same results in the same order.

The port of ``dcfm_tpu/analysis/engine.py``.  Its symbol table carries
what the port's rules need across modules: threaded classes (locks.py),
loader helpers (lifetime.py), and the call graph that closes the
captured set - a function a CUDA-graph capture reaches in one module is
captured code in every module it calls into (linter.py's DCFM2xx/301).
"""

from __future__ import annotations

import ast
import hashlib
import json
import multiprocessing
import os
import subprocess
import tempfile
from concurrent.futures import ProcessPoolExecutor
from typing import Iterable, Optional

from dcfm_tpu_torch.analysis import lifetime, locks
from dcfm_tpu_torch.analysis.linter import (
    ATTR_CALL, Finding, _Module, lint_source)
from dcfm_tpu_torch.analysis.rules import ALL_RULES, RULES

# bumped whenever analysis semantics change so stale caches self-expire;
# the rules-registry digest is folded in as well
ENGINE_VERSION = 2

_SKIP_DIRS = {"__pycache__", ".git", ".jax_cache", ".pytest_cache",
              ".hypothesis"}


class Project:
    """Cross-module symbol table handed to the per-file checkers.
    ``traced`` is the dotted names of every function a capture reaches,
    closed over the call graph of all modules."""

    def __init__(self):
        self.threaded_classes: set = set()
        self.tainted_returners: set = set()
        self.traced: set = set()

    @classmethod
    def from_summaries(cls, summaries: Iterable[dict]) -> "Project":
        p = cls()
        edges: dict = {}
        frontier: list = []
        for s in summaries:
            p.threaded_classes.update(s.get("threaded_classes", ()))
            p.tainted_returners.update(s.get("tainted_returners", ()))
            frontier.extend(s.get("traced", ()))
            for name, callees in s.get("edges", {}).items():
                edges.setdefault(name, set()).update(callees)
            for name, target in s.get("reexports", {}).items():
                edges.setdefault(name, set()).add(target)
            for attr, defs in s.get("published", {}).items():
                edges.setdefault(f"{ATTR_CALL}{attr}", set()).update(defs)
        while frontier:
            name = frontier.pop()
            if name in p.traced:
                continue
            p.traced.add(name)
            frontier.extend(edges.get(name, ()))
        p.traced = {n for n in p.traced if not n.startswith(ATTR_CALL)}
        return p

    def digest(self) -> str:
        blob = json.dumps({
            "threaded_classes": sorted(self.threaded_classes),
            "tainted_returners": sorted(self.tainted_returners),
            "traced": sorted(self.traced),
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


def _summarize(source: str, path: str) -> dict:
    """Pass-1 product for one file: its symbol-table contribution."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return {}
    mod = _Module(tree, source, path)
    out = {"threaded_classes": sorted(locks.collect_threaded_classes(mod))}
    out.update(lifetime.collect_lifetime_summary(mod, mod.dotted))
    out["traced"] = sorted(
        {mod.dotted_of[d] for d in mod.traced if d in mod.dotted_of}
        | mod.traced_external)
    out["edges"] = mod.call_edges()
    out["reexports"] = mod.reexports()
    out["published"] = mod.published()
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


# A worker process starts in about a second (it imports the package,
# and with it torch), so a pool pays only on a large tree - the gate's
# ~120 files, not a directory of fixtures - and each worker gets many
# files.
_POOL_MIN_FILES = 64
_FILES_PER_WORKER = 16


def _pool(n_files: int) -> Optional[ProcessPoolExecutor]:
    """Spawned workers (not forked: the parent has torch's threads) for
    a tree of ``n_files``, or None for a small one.  They start when the
    first file is handed out: a warm cache starts none."""
    workers = min(len(os.sched_getaffinity(0)),
                  n_files // _FILES_PER_WORKER)
    if n_files < _POOL_MIN_FILES or workers < 2:
        return None
    return ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))


def _map(pool, fn, calls: list) -> list:
    """``fn(*args)`` for each ``args`` of ``calls``, in order, in the
    pool's workers or here: the same list either way."""
    if pool is None or not calls:
        return [fn(*args) for args in calls]
    return list(pool.map(fn, *zip(*calls), chunksize=4))


def lint_project(paths: Iterable[str], *, exclude: Iterable[str] = (),
                 cache_path: Optional[str] = None,
                 changed_only: bool = False,
                 root: Optional[str] = None) -> list:
    """Project-aware lint over ``paths``; the drop-in upgrade behind
    :func:`dcfm_tpu_torch.analysis.lint_paths`."""
    root = os.path.abspath(root or os.getcwd())
    files = collect_files(paths, exclude)
    pool = _pool(len(files))
    try:
        return _lint_files(files, pool, cache_path, changed_only, root)
    finally:
        if pool is not None:
            pool.shutdown()


def _lint_files(files: list, pool, cache_path: Optional[str],
                changed_only: bool, root: str) -> list:
    cache = _load_cache(cache_path)

    # pass 1: hashes + symbol-table summaries (cached per content hash)
    sources: dict = {}
    hashes: dict = {}
    new_cache: dict = {}
    fresh: list = []
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
            new_cache[ap] = {"sha": sha, "summary": entry["summary"]}
        else:
            sources[ap] = raw.decode("utf-8", errors="replace")
            new_cache[ap] = {"sha": sha}
            fresh.append((sources[ap], path))
    for (_, path), summary in zip(fresh, _map(pool, _summarize, fresh)):
        new_cache[os.path.abspath(path)]["summary"] = summary

    project = Project.from_summaries(
        entry["summary"] for entry in new_cache.values())
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

    per_file: dict = {}
    stale: list = []
    for path in targets:
        ap = os.path.abspath(path)
        if ap not in hashes:
            continue
        entry = cache.get(ap)
        if (entry and entry.get("sha") == hashes[ap]
                and entry.get("project_sha") == project_sha
                and "findings" in entry):
            per_file[ap] = [Finding(*row) for row in entry["findings"]]
        else:
            if ap not in sources:
                with open(path, "rb") as f:
                    sources[ap] = f.read().decode("utf-8",
                                                  errors="replace")
            per_file[ap] = None
            stale.append((sources[ap], path, project))
    for (_, path, _), found in zip(stale, _map(pool, lint_source, stale)):
        per_file[os.path.abspath(path)] = found
    findings: list = []
    for ap, found in per_file.items():
        new_cache[ap]["project_sha"] = project_sha
        new_cache[ap]["findings"] = [
            [f.path, f.line, f.col, f.rule, f.message] for f in found]
        findings.extend(found)

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
