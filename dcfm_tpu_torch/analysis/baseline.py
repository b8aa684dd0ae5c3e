"""Finding baseline: pre-existing findings don't block CI, new ones do.

The whole-tree lint gate (scripts/ci_check.sh) runs with a committed
baseline file.  Each baselined finding is identified by a *fingerprint*
that is deliberately line-number-free - sha1 over

    (repo-relative path, rule id, stripped source line text, ordinal)

where the ordinal disambiguates several identical findings on identical
line texts in one file.  Editing unrelated parts of a file (shifting
line numbers) does not invalidate the baseline; editing the flagged
line itself does - which is exactly when a human should re-look.

The file format is JSON, sorted, one entry per fingerprint, with the
human-readable context kept alongside so a baseline diff in review
reads like a findings list:

    {"version": 1,
     "entries": [{"fingerprint": "...", "rule": "DCFM502",
                  "path": "scripts/foo.py", "text": "t.start()"}]}

``apply_baseline`` splits findings into (new, suppressed) and reports
which baseline entries no longer match anything (stale - the finding
was fixed; refresh with --write-baseline to expire them).

The port's copy of ``dcfm_tpu/analysis/baseline.py``: the same code, so the
same findings on the same source (held finding for finding by
tests/test_torch_analysis.py).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Iterable, Optional

BASELINE_VERSION = 1


def _relpath(path: str, root: str) -> str:
    try:
        rel = os.path.relpath(os.path.abspath(path), os.path.abspath(root))
    except ValueError:
        return path.replace("\\", "/")
    return rel.replace("\\", "/")


def _line_text(path: str, line: int, cache: dict) -> str:
    if path not in cache:
        try:
            with open(path, "r", encoding="utf-8") as f:
                cache[path] = f.read().splitlines()
        except OSError:
            cache[path] = []
    lines = cache[path]
    return lines[line - 1].strip() if 0 < line <= len(lines) else ""


def fingerprints(findings: Iterable, root: str) -> list:
    """[(finding, fingerprint, relpath, text)] with stable ordinals."""
    cache: dict = {}
    counts: dict = {}
    out = []
    for f in findings:
        rel = _relpath(f.path, root)
        text = _line_text(f.path, f.line, cache)
        key = (rel, f.rule, text)
        n = counts.get(key, 0)
        counts[key] = n + 1
        fp = hashlib.sha1(
            f"{rel}::{f.rule}::{text}::{n}".encode("utf-8")).hexdigest()
        out.append((f, fp, rel, text))
    return out


def build_baseline(findings: Iterable, root: str) -> dict:
    entries = [
        {"fingerprint": fp, "rule": f.rule, "path": rel, "text": text}
        for f, fp, rel, text in fingerprints(findings, root)]
    entries.sort(key=lambda e: (e["path"], e["rule"], e["fingerprint"]))
    return {"version": BASELINE_VERSION, "entries": entries}


def load_baseline(path: str) -> Optional[dict]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(data, dict) or "entries" not in data:
        return None
    return data


def save_baseline(path: str, data: dict) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".baseline-", suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def apply_baseline(findings: Iterable, baseline: dict, root: str):
    """(new_findings, suppressed_findings, stale_fingerprint_entries)."""
    known = {e["fingerprint"] for e in baseline.get("entries", [])}
    new, suppressed, seen = [], [], set()
    for f, fp, _rel, _text in fingerprints(findings, root):
        if fp in known:
            suppressed.append(f)
            seen.add(fp)
        else:
            new.append(f)
    stale = [e for e in baseline.get("entries", [])
             if e["fingerprint"] not in seen]
    return new, suppressed, stale
