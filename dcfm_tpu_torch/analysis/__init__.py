"""dcfm-lint for the port: the JAX package's static analysis, and a trace
gate over the port's graphed trips.

The port's copy of ``dcfm_tpu/analysis/``, importing nothing of it:

* **the AST lint** (``linter.py``, ``locks.py``, ``lifetime.py``,
  ``engine.py``, ``baseline.py``, ``rules.RULES``): copies of the JAX
  package's modules, so the same source gives the same findings, the
  whole-tree gate reads the same ``LINT_BASELINE.json`` and SARIF, JSON
  and ``--changed`` behave alike.  The rules stay JAX-aware, as they are.
* **the trace gate** (``registry.py``, ``tracecheck.py``,
  ``rules.TRACE_RULES``): the JAX gate traces jaxprs; this one runs each
  registered entry of the port once under a recording
  ``TorchDispatchMode`` and checks the aten ops it dispatched - the
  collective groups of the mesh's seam (DCFM1801/1802/1808), dtype leaks
  (1803/1804), host syncs (1805), in-place carries (1806), stable static
  keys (1807), and no variate drawn or CUDA event touched inside a
  sweep-body entry (1809: the graphs replay their Philox offsets).
* **test-isolated** (``isolate.py``): one pytest subprocess per file.

Run it as ``dcfm-tpu-torch lint <paths>`` or ``python -m
dcfm_tpu_torch.analysis``; ``--trace`` for the gate (on the card by
default, ``--device cpu`` on the CPU).  Suppress a single finding with an
inline ``# dcfm: ignore[RULE_ID]`` comment on the flagged line.
Importing this package (and ``registry.py``) imports no torch.
"""

from dcfm_tpu_torch.analysis.linter import (
    Finding, lint_file, lint_paths, lint_source)
from dcfm_tpu_torch.analysis.rules import RULES, Rule

__all__ = [
    "Finding", "RULES", "Rule", "lint_file", "lint_paths", "lint_source",
    "lint_project", "main",
]


def lint_project(paths, **kwargs):
    """Project-aware lint (cross-module symbol table, optional cache /
    changed-only selection); see analysis/engine.py."""
    from dcfm_tpu_torch.analysis.engine import lint_project as _lp
    return _lp(paths, **kwargs)


def main(argv=None) -> int:
    from dcfm_tpu_torch.analysis.__main__ import main as _main
    return _main(argv)
